"""Solver sidecar: the snapshot-request / assignment-response process
boundary.

The control plane (session, statement, plugins, effectors) packs the
snapshot (SnapshotArrays.packed) and ships it over a local unix socket; the
sidecar process owns the card, keeps the buffers device-resident across
sessions (PackedDeviceCache — deltas computed server-side, so the socket
carries plain full buffers), runs the solve, and returns the assignment
vector. The control plane stays a light pure-Python process (restartable,
no CUDA context), while the solver process pins the card. A control plane
that uses a sidecar builds its cache with ``device="cpu"``.

Protocol: length-prefixed frames, a JSON header + raw little-endian array
bytes, the JAX package's wire format byte for byte, so a client of either
package talks to a server of either. Every reply of this package's server
names its device in the header (``"device"``, ignored by the JAX
package's client): a client that solves on a CUDA device treats a
failed solve as the card's failure — the session raises, it never
finishes on the host oracle — exactly as a failed in-process CUDA solve
does. A client expects the card from the start (``SidecarSolver(path)``,
``device="cuda"`` by default, since this package's sidecar binary always
solves on CUDA): a sidecar that has not answered yet, or is gone, fails
the session too, and a reply naming another device raises. Only a client
built with ``device=None`` learns the device from the replies, and
against a server on the CPU (or one that names no device) keeps the host
fallback.

The server builds the kernel library and opens the CUDA context before
it binds its socket, and the binary first removes a socket a killed
predecessor left, so a socket that exists belongs to a server that can
solve (a readiness probe tests for it); it removes the socket when it
stops.

    python -m volcano_tpu_torch.parallel.sidecar /path/to.sock
"""

from __future__ import annotations

import json
import os
import select
import socket
import struct
import threading
import time
from typing import Optional, Tuple

import numpy as np

_MAGIC = b"VTS1"

#: frame-size ceilings: a corrupt or hostile local client
#: must not drive unbounded allocation. 1 MiB of JSON header and 256 MiB
#: per blob dwarf any real snapshot (10k x 2k packs to ~0.5 MB) while
#: keeping a garbage length prefix from OOMing the solver process.
MAX_HEADER_BYTES = 1 << 20
MAX_BLOB_BYTES = 256 << 20


class SidecarUnavailable(ConnectionError):
    """The sidecar's socket is missing or refuses, or the connection
    dropped: no server answered."""

    reason = "sidecar_unavailable"


class SidecarError(RuntimeError):
    """The server answered with an error frame (its solve failed)."""

    reason = "sidecar_error"


class SidecarDeviceMismatch(RuntimeError):
    """A reply named another device than the client expects."""

    reason = "sidecar_device"


# -- framing ----------------------------------------------------------------

def _send_frame(sock: socket.socket, header: dict, blobs) -> None:
    meta = dict(header)
    meta["blobs"] = [{"dtype": str(b.dtype), "shape": list(b.shape)}
                     for b in blobs]
    hdr = json.dumps(meta).encode()
    sock.sendall(_MAGIC + struct.pack("<I", len(hdr)) + hdr)
    for b in blobs:
        raw = np.ascontiguousarray(b).tobytes()
        sock.sendall(struct.pack("<Q", len(raw)) + raw)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("sidecar socket closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket):
    magic = _recv_exact(sock, 4)
    if magic != _MAGIC:
        raise ConnectionError(f"bad magic {magic!r}")
    (hlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    if hlen > MAX_HEADER_BYTES:
        raise ConnectionError(f"header length {hlen} exceeds cap "
                              f"{MAX_HEADER_BYTES}")
    header = json.loads(_recv_exact(sock, hlen))
    blobs = []
    for spec in header.pop("blobs", []):
        (blen,) = struct.unpack("<Q", _recv_exact(sock, 8))
        if blen > MAX_BLOB_BYTES:
            raise ConnectionError(f"blob length {blen} exceeds cap "
                                  f"{MAX_BLOB_BYTES}")
        arr = np.frombuffer(_recv_exact(sock, blen),
                            dtype=np.dtype(spec["dtype"]))
        blobs.append(arr.reshape(spec["shape"]))
    return header, blobs


def _layout_wire(layout):
    return [[k, kind, off, size, list(shape)]
            for k, kind, off, size, shape in layout]


def _layout_unwire(wire):
    return tuple((k, kind, off, size, tuple(shape))
                 for k, kind, off, size, shape in wire)



# -- server (owns the card) -------------------------------------------------

class SolverServer:
    """Accept loop serving solve requests; one at a time (one card).
    ``device``: where the solves run — None means the CUDA device and
    raises when there is none; ``"cpu"`` keeps them on the host."""

    def __init__(self, path: str, device=None):
        from ..ops.convert import resolve_device

        self.path = path
        self.device = resolve_device(device)
        #: the device every reply names
        self.device_name = str(self.device)
        self._listener: Optional[socket.socket] = None
        self._inode: Optional[int] = None
        self._stop = threading.Event()
        self._device_cache = None
        #: seconds the kernel library took to build or load (None: not
        #: loaded, a server on the CPU); whether it was built here
        self.build_s: Optional[float] = None
        self.built = False
        #: requests answered without an error frame
        self.answered = 0

    def prepare(self) -> None:
        """Pay before the socket exists what a first solve would pay
        under the client's timeout: on a CUDA device, the kernel library
        (built with nvcc into the build directory if it is not there —
        $VOLCANO_COMPILE_CACHE_DIR re-points it) and the CUDA context."""
        self._ensure()
        if self.device.type != "cuda":
            return
        import torch

        from ..ops import _build
        from ..ops import fused_choice as fc
        from ..ops.precompile import configure_compilation_cache

        configure_compilation_cache()
        t0 = time.perf_counter()
        self.built = bool(_build.build("fused_choice"))
        fc._kernel()
        self.build_s = time.perf_counter() - t0
        torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)

    def bind(self) -> None:
        """``prepare``, then create the socket: from then on a client
        that finds the socket reaches a server that can solve."""
        self.prepare()
        try:
            os.unlink(self.path)
        except OSError:
            pass
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.path)
        self._inode = os.stat(self.path).st_ino
        # backlog > 1 so a second client connects instead of hanging in
        # the kernel queue forever; it gets an explicit busy error below
        self._listener.listen(4)

    def _ensure(self):
        if self._device_cache is None:
            from ..ops.device_cache import PackedDeviceCache
            self._device_cache = PackedDeviceCache(device=self.device)
        return self._device_cache

    def _solve(self, header, blobs):
        from ..ops import fused_choice as fc
        from ..ops.solver import solve_allocate_packed2d
        from ..resilience import faults

        fbuf, ibuf = blobs[0], blobs[1]
        params = {}
        for name, blob in zip(header["param_names"], blobs[2:]):
            # received blobs are read-only views of the frame's bytes
            params[name] = blob.copy() if blob.ndim else np.float32(blob)
        layout = _layout_unwire(header["layout"])
        dcache = self._ensure()
        launches = fc.fused_choice.launches
        f2d, i2d = dcache.update(fbuf, ibuf, layout)
        try:
            # chaos seam: a solve that fails on the server after the
            # arena's scatter (resilience/faultinject.py)
            faults.fire("sidecar_solve")
            res = solve_allocate_packed2d(
                f2d, i2d, layout, dcache.params_device(params),
                herd_mode=header["herd_mode"],
                score_families=tuple(header["score_families"]),
                use_queue_cap=header["use_queue_cap"],
                use_drf_order=header.get("use_drf_order", False),
                use_hdrf_order=header.get("use_hdrf_order", False),
                work_conserving=header.get("work_conserving", True))
            assigned = res.assigned.cpu().numpy()
            kind = res.kind.cpu().numpy()
        except Exception:
            # update() committed the mirror with the scatter: the resident
            # buffers can no longer be trusted against it
            dcache.invalidate()
            raise
        return {"rounds": int(res.rounds.item()),
                "shipped_chunks": dcache.last_shipped_chunks,
                "launches": fc.fused_choice.launches - launches}, \
            [assigned, kind]

    def _solve_evict(self, header, blobs):
        """Eviction solve: arrays/victims/params arrive as named blobs;
        the uniform fast path is chosen when the victim dict carries
        job_req/job_acct/job_count (the client's uniformity verdict)."""
        from ..ops.evict import solve_evict, solve_evict_uniform

        names = header["blob_names"]
        arrays, victims, params = {}, {}, {}
        for name, blob in zip(names, blobs):
            group, key = name.split(".", 1)
            val = blob.copy() if blob.ndim else np.float32(blob)
            {"a": arrays, "v": victims, "p": params}[group][key] = val
        families = tuple(header["score_families"])
        if "job_req" in victims:
            res = solve_evict_uniform(
                arrays, victims, params, score_families=families,
                require_freed_covers=header["require_freed_covers"],
                stop_at_need=header["stop_at_need"], device=self.device)
        else:
            res = solve_evict(
                arrays, victims, params, score_families=families,
                require_freed_covers=header["require_freed_covers"],
                allow_revert=header["allow_revert"],
                stop_at_need=header["stop_at_need"], device=self.device)
        return {}, [res.assigned.cpu().numpy(),
                    res.evicted_by.cpu().numpy()]

    def serve_forever(self) -> None:
        """Serve until ``stop``, a shutdown request or an exception; the
        socket is removed on the way out (``bind`` first if not bound)."""
        if self._listener is None:
            self.bind()
        try:
            self._accept_loop()
        finally:
            self._unlink()

    def _unlink(self) -> None:
        # only the socket this server bound: a successor may have bound
        # the path since
        try:
            if os.stat(self.path).st_ino == self._inode:
                os.unlink(self.path)
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                break
            with conn:
                try:
                    while True:
                        # between frames, watch the listener too: a second
                        # client gets an explicit busy error instead of
                        # queueing silently behind this one (one card, one
                        # client at a time). The served connection is
                        # handled FIRST: when it has pending data or EOF
                        # (a restarting scheduler whose old socket just
                        # closed), that must resolve before any
                        # busy-reject, or the legitimate reconnect would
                        # be bounced while the stale client is gone.
                        ready, _, _ = select.select(
                            [conn, self._listener], [], [])
                        if conn not in ready:
                            # only the listener is ready: the served
                            # client is verifiably alive-and-idle (a dead
                            # one would be readable with EOF)
                            try:
                                conn2, _ = self._listener.accept()
                                with conn2:
                                    _send_frame(conn2, {
                                        "error": "busy: another client "
                                                 "is being served",
                                        "device": self.device_name}, [])
                            except OSError:
                                pass
                            continue
                        header, blobs = _recv_frame(conn)
                        if header.get("op") == "shutdown":
                            self._stop.set()
                            return
                        try:
                            if header.get("op") == "solve_evict":
                                out_header, out_blobs = self._solve_evict(
                                    header, blobs)
                            else:
                                out_header, out_blobs = self._solve(header,
                                                                    blobs)
                            self.answered += 1
                        except Exception as e:  # noqa: BLE001
                            # a bad request or a failed solve must not kill
                            # the server or leave the client hanging:
                            # answer with an error frame and keep serving
                            out_header = {"error": f"{type(e).__name__}: "
                                                   f"{e}"}
                            out_blobs = []
                        out_header["device"] = self.device_name
                        _send_frame(conn, out_header, out_blobs)
                except (ConnectionError, OSError, ValueError):
                    # the client went away (await the next one), or stop()
                    # closed the listener under select (ValueError: fd -1)
                    continue

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                # wakes a thread blocked in accept(); close() alone does not
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()


# -- client (the control plane side) ----------------------------------------

class SidecarSolver:
    """Drop-in allocate / eviction solve over the sidecar socket. The
    allocate and preempt/reclaim actions use it instead of the in-process
    solve when the session exposes one (SchedulerCache.sidecar).

    ``device`` is the server's device as its last reply named it (None
    until a reply names one). ``expected`` (the ``device`` argument,
    ``"cuda"`` by default) is the device type the server must solve on: a
    reply naming another (or none) raises SidecarDeviceMismatch; None
    expects nothing and learns the device from the replies. ``on_card``
    is True when the expected device, or else the last named one, is a
    CUDA device: from the start for a client expecting the card, so a
    session before the server's first answer already has no host
    fallback.
    Failures raise typed: SidecarUnavailable (no server answered),
    SidecarError (an error frame), each with its ``reason``.
    ``last_request_bytes`` / ``last_rtt_ms``: the payload bytes and the
    round trip of the last request."""

    def __init__(self, path: str, timeout: float = 120.0, device="cuda"):
        self.path = path
        self.timeout = timeout
        self.expected: Optional[str] = None if device is None \
            else str(device)
        self._sock: Optional[socket.socket] = None
        self.device: Optional[str] = None
        self.last_request_bytes = 0
        self.last_rtt_ms = 0.0

    @property
    def on_card(self) -> bool:
        dev = self.expected or self.device
        return bool(dev) and dev.startswith("cuda")

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self.timeout)
            s.connect(self.path)
            self._sock = s
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def shutdown_server(self) -> None:
        sock = self._connect()
        _send_frame(sock, {"op": "shutdown"}, [])
        self.close()

    def _request(self, header, blobs):
        t0 = time.perf_counter()
        try:
            sock = self._connect()
            _send_frame(sock, header, blobs)
            out_header, out_blobs = _recv_frame(sock)
        except OSError as e:
            self.close()
            raise SidecarUnavailable(
                f"sidecar {header.get('op')} at {self.path}: "
                f"{type(e).__name__}: {e}") from e
        self.last_rtt_ms = (time.perf_counter() - t0) * 1e3
        self.last_request_bytes = sum(np.asarray(b).nbytes for b in blobs)
        named = out_header.get("device")
        if named:
            self.device = named
        if self.expected is not None and (named or "").split(":")[0] \
                != self.expected.split(":")[0]:
            raise SidecarDeviceMismatch(
                f"the sidecar at {self.path} solves on "
                f"{named or 'an unnamed device'}, not {self.expected}")
        if "error" in out_header:
            raise SidecarError(
                f"sidecar {header.get('op')} failed on "
                f"{self.device or 'an unnamed device'}: "
                f"{out_header['error']}")
        return out_header, out_blobs

    def solve(self, fbuf, ibuf, layout, params,
              herd_mode: str = "pack",
              score_families: Tuple[str, ...] = ("binpack",),
              use_queue_cap: bool = False,
              use_drf_order: bool = False,
              use_hdrf_order: bool = False,
              work_conserving: bool = True):
        """Returns (assigned [T] int32, kind [T] int32, info dict)."""
        names, blobs = [], [fbuf, ibuf]
        for name, val in params.items():
            names.append(name)
            blobs.append(np.asarray(val))
        header = {
            "op": "solve",
            "layout": _layout_wire(layout),
            "param_names": names,
            "herd_mode": herd_mode,
            "score_families": list(score_families),
            "use_queue_cap": bool(use_queue_cap),
            "use_drf_order": bool(use_drf_order),
            "use_hdrf_order": bool(use_hdrf_order),
            "work_conserving": bool(work_conserving),
        }
        out_header, out_blobs = self._request(header, blobs)
        return out_blobs[0], out_blobs[1], out_header

    def solve_evict(self, arrays, victims, params,
                    score_families: Tuple[str, ...] = ("kube",),
                    require_freed_covers: bool = False,
                    allow_revert: bool = True,
                    stop_at_need: bool = True):
        """Eviction solve over the socket (preempt/reclaim). Returns
        (assigned [T] int32, evicted_by [V] int32). Arrays ship as raw
        named blobs, unlike allocate's server-side delta-cached buffers:
        each evict flatten has a different task set per call, so a second
        delta cache would mostly thrash."""
        names, blobs = [], []
        for group, d in (("a", arrays), ("v", victims), ("p", params)):
            for key, val in d.items():
                names.append(f"{group}.{key}")
                blobs.append(np.asarray(val))
        header = {
            "op": "solve_evict",
            "blob_names": names,
            "score_families": list(score_families),
            "require_freed_covers": bool(require_freed_covers),
            "allow_revert": bool(allow_revert),
            "stop_at_need": bool(stop_at_need),
        }
        _, out_blobs = self._request(header, blobs)
        return out_blobs[0], out_blobs[1]


def build_parser():
    """The entry point's argument parser."""
    import argparse

    ap = argparse.ArgumentParser(prog="volcano-solver-sidecar")
    ap.add_argument("socket_path")
    return ap


class _Terminated(BaseException):
    """SIGTERM, raised out of whatever the main thread waits in (not an
    Exception: a solve's error handler must not answer it)."""


def _terminate(*_args):
    raise _Terminated


def main(argv=None) -> int:
    """``python -m volcano_tpu_torch.parallel.sidecar /path/to.sock`` — the
    solver process entry point (owns the card; raises without one). The
    socket appears once the server can solve; SIGTERM removes it and
    exits 0."""
    import signal

    args = build_parser().parse_args(argv)
    # a socket left by a killed predecessor (SIGKILL, the OOM killer) in
    # the shared volume: no live server owns it at start, and a readiness
    # probe or a starting control plane must not take it for one while
    # this server builds
    try:
        os.unlink(args.socket_path)
    except FileNotFoundError:
        pass
    from ..ops import fused_choice as fc

    t0 = time.perf_counter()
    signal.signal(signal.SIGTERM, _terminate)
    server = SolverServer(args.socket_path)
    try:
        server.bind()
        if server.build_s is None:
            kernel = "no kernel library"
        else:
            kernel = (f"kernel library {'built' if server.built else 'found'}"
                      f" in {server.build_s:.3f} s")
        print(f"solver sidecar listening on {args.socket_path} "
              f"(device {server.device}, {kernel}, ready "
              f"{time.perf_counter() - t0:.3f} s after start)", flush=True)
        server.serve_forever()
    except _Terminated:
        pass
    finally:
        server.stop()
        server._unlink()
    print(f"solver sidecar stopped: {server.answered} requests answered, "
          f"{fc.fused_choice.launches} kernel launches", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
