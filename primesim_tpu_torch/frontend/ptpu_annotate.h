/* ptpu_annotate.h — user annotation hooks for the capture frontend.
 *
 * The LD_PRELOAD shim (ptpu_capture.cpp) observes memory traffic only at
 * interposed library calls (memcpy/memset/memmove/memcmp/str*). A target
 * program can report its ORDINARY loads and stores explicitly:
 *
 *     #include "ptpu_annotate.h"
 *     for (i = 0; i < n; i++) sum += a[i];
 *     PTPU_LOAD(a, n * sizeof(a[0]));   // tell the simulator about it
 *
 * The hooks resolve dynamically and are no-ops when the program runs
 * without the shim, so annotated binaries need no build-time dependency.
 */
#ifndef PTPU_ANNOTATE_H_
#define PTPU_ANNOTATE_H_

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* weak: defined by libptpu_capture.so when preloaded, absent otherwise */
void ptpu_capture_load(const void* p, size_t n) __attribute__((weak));
void ptpu_capture_store(const void* p, size_t n) __attribute__((weak));

#define PTPU_LOAD(p, n) \
  do { if (ptpu_capture_load) ptpu_capture_load((p), (n)); } while (0)
#define PTPU_STORE(p, n) \
  do { if (ptpu_capture_store) ptpu_capture_store((p), (n)); } while (0)

#ifdef __cplusplus
}
#endif

#endif /* PTPU_ANNOTATE_H_ */
