"""The round solve's round body replayed from CUDA graphs kept across
solves.

A round of ``ops.solver.solve_allocate`` is a few hundred small kernels
(the default conf's drf and queue caps) to about a thousand (hdrf), with
no host read among them, on shapes that the solve's inputs fix: the
host's launches, not the card, set its pace. Here the round body is
captured once per key in the process and replayed, one launch a round,
in the solves that follow.

- The key: the device, the flags the body branches on, and every
  solve-constant input's name, shape and dtype. Within a key, a variant
  is a phase (idle or future, capped or not).
- A variant's first call at a key runs eagerly and doubles as its
  warm-up; its second call captures, in the same solve or a later one;
  later calls replay. A shape seen once is never captured.
- A graph reads only tensors it owns. The solve-constant inputs are
  copied into the key's static copies once per solve (``stage``); the
  tensors the body derives from them (the fused kernel's operands, the
  fairness state) are rebuilt from those copies by a second graph, the
  prelude, captured before the first round's. The round's carry lives in
  static tensors that the body updates in place; the solve's carry
  refers to them between rounds (``SolveGraphs.round``) and is cut loose
  from them when the solve ends (``SolveGraphs.close``).
- One solve at a time holds a key; a solve that finds its key held runs
  eagerly. At most ``MAX_KEYS`` keys are kept: the least recently used
  one that no solve holds is dropped, and its memory pool handed back.
- A capture that raises leaves the key eager for good, with a warning:
  a wrong answer is never the fallback.
- The hand-written kernel's calls stay out of the graph (``outside``):
  a replay runs the graph's pieces with each call launched from Python
  between them, so the kernel's launch count, the audits and the shape
  records of whatever wraps it see every call, as they do eagerly.

The backend (``CudaGraphs``) does the capturing and replaying; a stand-in
with the same methods lets the policy run where there is no card.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch

log = logging.getLogger(__name__)

#: the most keys kept in a process
MAX_KEYS = 8

#: the round's carry, as ``ops.solver._State`` names it
STATE = ("idle", "pipe", "npods", "qalloc", "jobres", "assigned", "kind",
         "excluded")


class CudaGraphs:
    """Capture and replay on the card. A capture runs on a side stream,
    its pool's (``ops.hdrf._PoolShelf``): the job updater's workers and
    the bind effectors launch on the ambient stream during a cycle, and
    what another thread queues on a capturing stream lands in the graph.
    ``thread_local``: those threads' own CUDA calls do not invalidate this
    thread's capture. Not ``torch.cuda.graph``, whose entry synchronises
    the device and empties the allocator's cache."""

    @staticmethod
    def serves(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def take_pool(device):
        """(pool handle, its capture stream, the graph that holds the pool
        or None)."""
        from .hdrf import _POOLS
        return _POOLS.take(device)

    @staticmethod
    def give_pool(device, pool, graph) -> None:
        from .hdrf import _POOLS
        _POOLS.give(device, pool[0], pool[1], graph)

    @staticmethod
    def capture(fn: Callable, device, pool):
        """(graph, fn's result): ``fn`` captured, not run, in pieces: each
        ``outside`` call ends a piece and begins the next. Raises what the
        capture raised."""
        handle, side = pool[0], pool[1]
        graph = _Pieces()
        open_ = []

        def begin() -> None:
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=handle, capture_error_mode="thread_local")
            open_.append(g)
            graph.graphs.append(g)

        def end() -> None:
            open_.pop().capture_end()

        def split(call, args, kw, outputs):
            outs = outputs()            # in the pool, read by the next piece
            end()
            graph.calls.append((call, args, kw, outs))
            begin()
            return outs

        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            try:
                begin()
                _local.split = split
                out = fn()
            finally:
                _local.split = None
                if open_:
                    end()
        return graph, out

    @staticmethod
    def replay(graph: "_Pieces", device) -> None:
        # a replay launches on the current device's stream
        with torch.cuda.device(device):
            for i, g in enumerate(graph.graphs):
                g.replay()
                if i < len(graph.calls):
                    run_kept(*graph.calls[i])

    @staticmethod
    def mark(device):
        """An event after the work queued so far on the current stream."""
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        return done

    @staticmethod
    def wait(device, mark) -> None:
        torch.cuda.current_stream(device).wait_event(mark)


class _Pieces:
    """A graph captured in pieces (``graphs``), with the calls that run
    from Python between them (``calls``: callable, args, kwargs, the
    tensors its results are copied into)."""

    def __init__(self):
        self.graphs, self.calls = [], []


_local = threading.local()


def outside(call: Callable, args: tuple, kw: dict, outputs: Callable):
    """``call(*args, **kw)``; inside a capture on this thread, a call kept
    out of the graph instead: it runs from Python between two pieces of
    the graph on every replay (``run_kept``), made as an eager round makes
    it, so whatever wraps ``call`` sees each one; its results are copied
    into tensors that ``outputs()`` makes here, once, which are returned
    for the capture to read on."""
    split = getattr(_local, "split", None)
    if split is None:
        return call(*args, **kw)
    return split(call, args, kw, outputs)


def run_kept(call: Callable, args: tuple, kw: dict, outs: tuple) -> None:
    """A kept call, as a replay makes it: ``call(*args, **kw)``, its
    results copied into ``outs``."""
    for o, r in zip(outs, call(*args, **kw)):
        o.copy_(r)


class _Key:
    """One key's graphs and the static tensors they read and write."""

    def __init__(self, device):
        self.device = device
        #: variant -> calls seen
        self.calls: Dict[tuple, int] = {}
        #: variant -> (graph, its ``got`` output)
        self.graphs: Dict[tuple, tuple] = {}
        self.failed = False
        self.busy = False
        #: the backend's event after the last holder's work, or None
        self.done = None
        #: (pool handle, capture stream) once a capture took one
        self.pool = None
        #: name -> static copy of a solve-constant input
        self.inputs: Optional[Dict[str, torch.Tensor]] = None
        #: the graph that builds ``body``'s tensors from ``inputs``
        self.prelude = None
        #: the round body built over ``inputs`` (``build``'s result)
        self.body = None
        #: name -> static tensor of the carry
        self.state: Optional[Dict[str, torch.Tensor]] = None

    def drop(self, backend) -> None:
        """Hand the pool back, with one of the graphs that hold it."""
        holder = self.prelude
        self.graphs, self.prelude, self.body = {}, None, None
        self.inputs = self.state = None
        if self.pool is not None:
            if self.done is not None:
                backend.wait(self.device, self.done)
            backend.give_pool(self.device, self.pool, holder)
        self.pool = None


class RoundGraphs:
    """The process's keys, by least recent use; ``checkout`` and
    ``checkin`` hand one to one solve at a time."""

    def __init__(self, backend=None, bound: int = MAX_KEYS):
        self.backend = backend if backend is not None else CudaGraphs()
        self.bound = bound
        self.lock = threading.Lock()
        self.keys: "OrderedDict[tuple, _Key]" = OrderedDict()

    def serves(self, device: torch.device) -> bool:
        return self.backend.serves(device)

    def checkout(self, key, device) -> Optional[_Key]:
        """The key's entry, held for the caller; None while another solve
        holds it, or while every kept key is held and the bound is met."""
        dropped = []
        with self.lock:
            entry = self.keys.get(key)
            if entry is None:
                for k in list(self.keys):
                    if len(self.keys) < self.bound:
                        break
                    if not self.keys[k].busy:
                        dropped.append(self.keys.pop(k))
                if len(self.keys) >= self.bound:
                    entry = None
                else:
                    entry = self.keys[key] = _Key(device)
            elif entry.busy:
                entry = None
            if entry is not None:
                entry.busy = True
                self.keys.move_to_end(key)
        for old in dropped:
            old.drop(self.backend)
        if entry is not None and entry.done is not None:
            self.backend.wait(device, entry.done)
        return entry

    def checkin(self, entry: _Key) -> None:
        entry.done = self.backend.mark(entry.device)
        with self.lock:
            entry.busy = False

    def clear(self) -> None:
        """Drop every key that no solve holds."""
        with self.lock:
            gone = [self.keys.pop(k) for k in list(self.keys)
                    if not self.keys[k].busy]
        for old in gone:
            old.drop(self.backend)


#: the process's keys: a card's memory is the process's, not a solve's
GRAPHS = RoundGraphs()


def signature(inputs: Dict[str, torch.Tensor]) -> tuple:
    """Each input's name, shape and dtype, in name order."""
    return tuple((k, tuple(v.shape), v.dtype)
                 for k, v in sorted(inputs.items()))


class SolveGraphs:
    """One solve's rounds through the cache (``GRAPHS`` unless given).

    ``inputs`` (name -> tensor): everything solve-constant that the body
    reads, directly or through what ``build`` derives from it.
    ``build(inputs)`` makes the round body over the given tensors: an
    object whose ``run(st, variant)`` runs one round on the carry ``st``
    (an ``ops.solver._State``; it rebinds the carry's fields and returns
    the admitted rows [T] bool), reading nothing but those tensors, what
    it derives from them and the carry. ``flags``: what else the body
    branches on."""

    def __init__(self, device, flags: tuple, inputs: Dict[str, torch.Tensor],
                 build: Callable, cache: Optional[RoundGraphs] = None):
        self.cache = cache if cache is not None else GRAPHS
        self.device = device
        self.key = (device, flags, signature(inputs))
        self.inputs, self.build = inputs, build
        self.entry: Optional[_Key] = None
        self.tried = False
        self.staged = False

    def round(self, variant: tuple, st, eager: Callable) -> Tuple[object, str]:
        """One round of ``variant`` on ``st``: (admitted rows, how it ran:
        "eager", "capture" or "replay"). ``eager()`` runs it eagerly."""
        if not self.tried:
            self.tried = True
            self.entry = self.cache.checkout(self.key, self.device)
        e = self.entry
        if e is None or e.failed:
            return eager(), "eager"
        calls = e.calls[variant] = e.calls.get(variant, 0) + 1
        if variant in e.graphs:
            return self._replay(variant, st), "replay"
        if calls < 2:
            return eager(), "eager"
        try:
            self._capture(variant, st)
        except RuntimeError as err:
            log.warning("round solve: CUDA graph capture failed, the key "
                        "stays eager: %s: %s", type(err).__name__, err)
            # the pool is not handed back: the next capture takes a new one
            e.failed, e.graphs, e.pool = True, {}, None
            e.prelude = e.body = e.inputs = None
            return eager(), "eager"
        return self._replay(variant, st), "capture"

    def _prepare(self, st) -> None:
        """Stage this solve's inputs (once) and point the carry at the
        static carry, copying in the fields that an eager step rebound."""
        e, be = self.entry, self.cache.backend
        if not self.staged:
            self.staged = True
            if e.prelude is None:
                pool, side, holder = be.take_pool(self.device)
                e.inputs = {k: v.clone() for k, v in self.inputs.items()}
                e.prelude, e.body = be.capture(
                    lambda: self.build(e.inputs), self.device, (pool, side))
                # the prelude holds the pool now, in its previous
                # holder's place
                del holder
                e.pool = (pool, side)
            else:
                for k, v in self.inputs.items():
                    e.inputs[k].copy_(v)
            be.replay(e.prelude, self.device)
        if e.state is None:
            e.state = {f: getattr(st, f).clone() for f in STATE}
        for f in STATE:
            s, cur = e.state[f], getattr(st, f)
            if cur is not s:
                s.copy_(cur)
                setattr(st, f, s)

    def _capture(self, variant, st) -> None:
        from .solver import _State
        e = self.entry
        self._prepare(st)

        def step():
            g = _State(rounds=0, **e.state)
            got = e.body.run(g, variant)
            for f in STATE:
                new = getattr(g, f)
                if new is not e.state[f]:
                    e.state[f].copy_(new)
            return got

        e.graphs[variant] = self.cache.backend.capture(step, self.device,
                                                       e.pool)

    def _replay(self, variant, st):
        graph, got = self.entry.graphs[variant]
        self._prepare(st)
        self.cache.backend.replay(graph, self.device)
        return got

    def close(self, st) -> None:
        """Cut ``st`` loose from the static carry and hand the key back."""
        e, self.entry = self.entry, None
        if e is None:
            return
        if e.state is not None:
            for f in STATE:
                if getattr(st, f, None) is e.state[f]:
                    setattr(st, f, e.state[f].clone())
        self.cache.checkin(e)
