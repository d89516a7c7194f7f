/* ocean_like — a small SPLASH-2-ocean-shaped pthread workload for the
 * capture frontend: phases of private grid relaxation (memcpy traffic)
 * separated by a global barrier, plus a mutex-protected global reduction
 * each phase. Deterministic event STRUCTURE per thread (counts of
 * lock/unlock/barrier and memcpy lines), so tests can assert the captured
 * trace shape exactly.
 *
 * Build: gcc -O2 -o ocean_like ocean_like.c -lpthread
 * Usage: ocean_like [n_threads] [n_phases] [rows_per_thread]
 */
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define COLS 256 /* 1KB rows: 16 cache lines per row */

static int n_threads = 4, n_phases = 3, rows = 8;
static pthread_barrier_t phase_barrier;
static pthread_mutex_t sum_mu = PTHREAD_MUTEX_INITIALIZER;
static double global_sum = 0.0;

static void* worker(void* argp) {
  long id = (long)argp;
  double* grid = malloc(sizeof(double) * rows * COLS);
  double* next = malloc(sizeof(double) * rows * COLS);
  for (int i = 0; i < rows * COLS; i++) grid[i] = id + i * 1e-6;

  for (int p = 0; p < n_phases; p++) {
    double local = 0.0;
    for (int r = 0; r < rows; r++) {
      for (int c = 1; c < COLS - 1; c++) {
        double v = 0.5 * grid[r * COLS + c] +
                   0.25 * (grid[r * COLS + c - 1] + grid[r * COLS + c + 1]);
        next[r * COLS + c] = v;
        local += v;
      }
      /* row copy-back: real memcpy traffic the shim captures as LD/ST */
      memcpy(&grid[r * COLS], &next[r * COLS], sizeof(double) * COLS);
    }
    pthread_mutex_lock(&sum_mu);
    global_sum += local;
    pthread_mutex_unlock(&sum_mu);
    pthread_barrier_wait(&phase_barrier);
  }
  free(grid);
  free(next);
  return NULL;
}

int main(int argc, char** argv) {
  if (argc > 1) n_threads = atoi(argv[1]);
  if (argc > 2) n_phases = atoi(argv[2]);
  if (argc > 3) rows = atoi(argv[3]);
  pthread_barrier_init(&phase_barrier, NULL, n_threads);
  pthread_t t[256];
  /* main thread is captured as core 0 but does no phase work */
  for (long i = 0; i < n_threads; i++)
    pthread_create(&t[i], NULL, worker, (void*)i);
  for (int i = 0; i < n_threads; i++) pthread_join(t[i], NULL);
  printf("ocean_like done: threads=%d phases=%d sum=%.3f\n", n_threads,
         n_phases, global_sum);
  return 0;
}
