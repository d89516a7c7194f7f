"""Wire protocol for `primetpu serve` — JSON lines over a unix socket
or a TCP listener (DESIGN.md §18: the elastic front-end admits many
concurrent clients over `--tcp HOST:PORT`; the unix socket stays for
single-host compat).

Each request and each reply is one JSON object on one line (UTF-8,
newline-terminated). Requests carry a `verb`; replies carry `ok: bool`
plus verb-specific fields, or `ok: false` with a structured `error`
object (same shape the CLI emits for run/sweep failures):

    {"error": {"type": "TraceError", "location": {...}, "detail": "..."}}

Verbs:
    submit  {trace_path|synth, overrides?, fold?, deadline_s?,
             max_steps?, priority?, client?}       -> {job_id} | RETRY_AFTER
    status  {job_id?}                              -> {job}|{jobs}
    result  {job_id}                               -> {job} (terminal only)
    wait    {job_id, timeout_s?}                   -> {job} once terminal
    cancel  {job_id}                               -> {job}
    health  {}                                     -> service stats + journal
                                                      recovery/fsync info
    metrics {}                                     -> {text} Prometheus
                                                      text exposition
    drain   {}                                     -> ack; server checkpoints
                                                      in-flight work and exits

Backpressure: a submit against a full queue gets
`{"ok": false, "retry_after_s": <float>, "error": {...}}` — the client
is expected to back off, not spin. A below-quorum replicated primary
(DESIGN.md §21) answers the same shape with a `ReplicaQuorumLost`
error; a fenced one adds `"fenced": true`.

The journal-replication verbs (`repl.hello/append/roll/seg/reset/
fetch/status` — serve/replicate.py) ride this same framing over a
PERSISTENT connection: the primary's sink holds one socket per replica
and exchanges one order/ack line pair per journal mutation, instead of
`request()`'s connect-per-call.

The JAX package's `serve/protocol.py`, copied whole for the port (it touches no
device), so the two packages' daemons, clients and state directories
speak one protocol and one journal format.
"""

from __future__ import annotations

import json
import socket

from ..chaos import sites as chaos

MAX_LINE = 1 << 20  # 1 MiB per message — traces travel by path, not value


class ServeUnavailable(ConnectionError):
    """Connect-phase failure: nothing was sent, so the caller may retry
    the SAME request without double-submitting. Post-send failures stay
    plain ConnectionError — retrying those could duplicate a submit."""


def parse_target(target) -> tuple[str, object]:
    """Classify a service target string: `("tcp", (host, port))` for
    `host:port` / `[v6::addr]:port`, else `("unix", path)`. A path can
    contain a colon only alongside a slash, so `./sock:dir/s` stays a
    path while `localhost:7077` is TCP."""
    t = str(target)
    if ":" in t and "/" not in t:
        host, _, port = t.rpartition(":")
        if host and port.isdigit():
            return "tcp", (host.strip("[]"), int(port))
    return "unix", t


def format_target(target) -> str:
    """Canonical display string for either target family."""
    fam, addr = parse_target(target)
    return f"{addr[0]}:{addr[1]}" if fam == "tcp" else str(addr)


def _connect(target, timeout_s: float):
    """Open a connected socket to a unix-path or host:port target.
    Raises ServeUnavailable on ANY connect-phase failure."""
    fam, addr = parse_target(target)
    if fam == "tcp":
        s = socket.socket(socket.AF_INET6 if ":" in addr[0]
                          else socket.AF_INET, socket.SOCK_STREAM)
    else:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout_s)
    try:
        s.connect(addr if fam == "tcp" else str(addr))
    except OSError as e:
        s.close()
        raise ServeUnavailable(
            f"cannot connect to {format_target(target)}: {e}"
        ) from e
    return s


def error_obj(exc: BaseException) -> dict:
    """Structured error payload for an exception: stable `type`, the
    exception's own `location()` dict when it has one (TraceError,
    FaultConfigError carry source coordinates), and the message."""
    loc = {}
    locate = getattr(exc, "location", None)
    if callable(locate):
        try:
            loc = dict(locate())
        except Exception:
            loc = {}
    return {
        "error": {
            "type": type(exc).__name__,
            "location": loc,
            "detail": str(exc),
        }
    }


def encode(obj: dict) -> bytes:
    line = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    data = line.encode() + b"\n"
    if len(data) > MAX_LINE:
        raise ValueError(f"message of {len(data)} bytes exceeds {MAX_LINE}")
    return data


def decode(line: bytes | str) -> dict:
    obj = json.loads(line)
    if not isinstance(obj, dict):
        raise ValueError("protocol message must be a JSON object")
    return obj


def read_line(f) -> dict | None:
    """Read one framed message from a file-like socket reader; None on
    EOF (peer closed). A partial line at EOF — the peer died mid-frame —
    is a TORN FRAME, rejected as such rather than handed to the JSON
    decoder: a truncated frame that happened to parse would silently
    become a different message."""
    line = f.readline(MAX_LINE + 1)
    if not line:
        return None
    if len(line) > MAX_LINE:
        raise ValueError("oversized protocol message")
    nl = b"\n" if isinstance(line, bytes) else "\n"
    if not line.endswith(nl):
        raise ValueError("torn protocol frame (peer closed mid-message)")
    return decode(line)


def socket_alive(target, timeout_s: float = 0.5) -> bool:
    """True when something ACCEPTS connections on `target` (unix path or
    host:port). False for a missing path or a STALE socket file — the
    inode a SIGKILLed daemon leaves behind, which refuses connections
    because no process listens. A connect that times out counts as alive
    (a bound-but-busy peer)."""
    try:
        _connect(target, timeout_s).close()
        return True
    except ServeUnavailable as e:
        if isinstance(e.__cause__, socket.timeout):
            return True  # bound and backlogged — definitely not stale
        return False  # ENOENT / ECONNREFUSED: absent or dead


def claim_socket_path(sock_path: str) -> None:
    """Make `sock_path` bindable: probe an existing socket file and
    unlink it ONLY when dead (previous owner was SIGKILLed and never got
    to clean up). A live listener raises — silently stealing a running
    daemon's socket would orphan it mid-service."""
    import os

    if not os.path.exists(sock_path):
        return
    if socket_alive(sock_path):
        raise RuntimeError(
            f"{sock_path}: a live server already accepts connections "
            "here; refusing to steal its socket (stop it first, or pick "
            "another --socket path)"
        )
    os.unlink(sock_path)  # stale: previous owner died without cleanup


def request(target, req: dict, timeout_s: float = 30.0,
            connect_timeout_s: float | None = None) -> dict:
    """One request/reply round trip against the server (unix path or
    host:port). `connect_timeout_s` bounds the connect phase separately
    (defaults to `timeout_s`); a connect failure raises ServeUnavailable
    (retry-safe), a post-send failure plain ConnectionError (not)."""
    s = _connect(target, connect_timeout_s
                 if connect_timeout_s is not None else timeout_s)
    try:
        s.settimeout(timeout_s)
        payload = encode(req)
        if not chaos.socket_send("protocol.send", s, payload):
            s.sendall(payload)
        f = s.makefile("rb")
        chaos.socket_recv("protocol.recv", s)
        reply = read_line(f)
    finally:
        s.close()
    if reply is None:
        raise ConnectionError(
            f"server at {format_target(target)} closed without reply"
        )
    return reply


def make_listener(target, handler_cls):
    """A threaded line-protocol listener on either family: a
    `ThreadingTCPServer` (SO_REUSEADDR; port 0 = kernel-assigned, read
    the real one from `.server_address`) or a `ThreadingUnixStreamServer`
    after `claim_socket_path`. The caller owns serve_forever/shutdown."""
    import socketserver

    fam, addr = parse_target(target)
    if fam == "tcp":
        class Listener(socketserver.ThreadingMixIn, socketserver.TCPServer):
            daemon_threads = True
            allow_reuse_address = True

        return Listener(addr, handler_cls), "tcp"

    class Listener(socketserver.ThreadingMixIn,
                   socketserver.UnixStreamServer):
        daemon_threads = True

    claim_socket_path(str(addr))
    return Listener(str(addr), handler_cls), "unix"
