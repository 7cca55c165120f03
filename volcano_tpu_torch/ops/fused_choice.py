"""Fused choice: feasibility + scoring + argmax + per-node max in one pass.

The counterpart of the JAX package's Pallas kernel (volcano_tpu's
``ops/pallas_kernels.py::fused_choice``). Each admission round of the
solver asks, for every (task, node) pair, whether the task fits and what
the node scores for it, and keeps only the per-task best node and the
per-node best score. The CUDA kernel (``csrc/fused_choice.cu``) does that
without ever writing the [T,N] feasibility or score matrices to device
memory; ``fused_choice_plain`` is the same function as dense PyTorch.

Wrapper rule: tensors on the CPU go to the plain version, tensors on a CUDA
device go to the kernel. Anything else raises; there is no fallback from
the kernel to the plain version.

Semantics (shared by both versions):
- feasibility == sig != 0 & eligible & pods_ok & le_fits(init_req, avail)
  with the positional thresholds (cpu 10 milli, memory 1 byte, scalars 10
  milli, ignored when the request itself is <= 10) and the REL_FIT_TOL
  term of ``solver.le_fits``;
- score mirrors ``solver.score_matrix`` term for term in the same float
  operation order (``_score`` is shared by both), so a pair scores the same
  bits on either path;
- best_idx is the first index among the per-task maxima; node_max is the
  max over tasks of the masked score. Infeasible pairs score NEG, so a task
  with no feasible node reports best_score NEG and best_idx 0.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

NEG = -1e30
#: scale-aware fit tolerance; see ``solver.le_fits``. A float32 value, so
#: every path (python scalar, CUDA literal) rounds it the same way.
REL_FIT_TOL = float(np.float32(5e-7))

_THR_CPU = 10.0
_THR_MEM = 1.0
_THR_SCALAR = 10.0
_FAMILY_BITS = {"binpack": 1, "kube": 2}


def _score(init_req, used, inv_alloc, node_static, pars,
           families: Tuple[str, ...]):
    """Dense [T,N] score from the packed parameter vector (``pack_pars``).
    The float operation order is the kernel's and the JAX package's dense
    ``score_matrix``'s: task and node binpack sums accumulated separately
    per dimension, kube terms summed before joining the score. Regrouping
    changes the last bit and flips argmax ties."""
    T, R = init_req.shape
    N = used.shape[0]
    score = torch.zeros((T, N), dtype=torch.float32, device=init_req.device)
    if "binpack" in families:
        bp_task = torch.zeros((T, N), dtype=torch.float32,
                              device=init_req.device)
        bp_node = torch.zeros((N,), dtype=torch.float32,
                              device=init_req.device)
        for r in range(R):
            w_r = pars[5 + r]
            bp_task = bp_task + init_req[:, r:r + 1] * (w_r * inv_alloc[:, r])
            bp_node = bp_node + (used[:, r] * w_r) * inv_alloc[:, r]
        score = score + pars[0] * (bp_task + bp_node) * pars[4]
    if "kube" in families:
        f0 = (used[:, 0] + init_req[:, 0:1]) * inv_alloc[:, 0]
        f1 = (used[:, 1] + init_req[:, 1:2]) * inv_alloc[:, 1]
        least = ((torch.clamp(1.0 - f0, 0.0, 1.0)
                  + torch.clamp(1.0 - f1, 0.0, 1.0)) / 2.0) * 100.0
        most = ((torch.clamp(f0, 0.0, 1.0)
                 + torch.clamp(f1, 0.0, 1.0)) / 2.0) * 100.0
        balanced = (1.0 - torch.abs(f0 - f1)) * 100.0
        score = score + (pars[1] * least + pars[2] * most
                         + pars[3] * balanced)
    return score + node_static


def fused_feasible(init_req, avail, eligible, pods_ok, sig_feas_i8):
    """The kernel's [T,N] feasibility mask, densely."""
    R = init_req.shape[1]
    feas = ((sig_feas_i8 != 0) & (eligible != 0)[:, None]
            & (pods_ok != 0)[None, :])
    for r in range(R):
        req_r = init_req[:, r:r + 1]
        av_r = avail[:, r]
        thr = _THR_CPU if r == 0 else (_THR_MEM if r == 1 else _THR_SCALAR)
        ok = (req_r < av_r + (thr + REL_FIT_TOL * torch.abs(av_r))) \
            | (req_r <= av_r)
        if r >= 2:
            ok = ok | (req_r <= 10.0)
        feas = feas & ok
    return feas


def fused_choice_plain(init_req, avail, used_now, inv_alloc, node_static,
                       eligible, pods_ok, sig_feas_i8, pars,
                       families: Tuple[str, ...]):
    """Dense PyTorch version of the kernel: [T,N] feasibility and score,
    then the masked per-task argmax and per-node max."""
    feas = fused_feasible(init_req, avail, eligible, pods_ok, sig_feas_i8)
    score = _score(init_req, used_now, inv_alloc, node_static, pars,
                   families)
    masked = torch.where(feas, score, NEG)
    best_i = torch.argmax(masked, dim=1)          # first max index
    best_s = masked.gather(1, best_i[:, None])[:, 0]
    node_max = torch.amax(masked, dim=0)
    return best_s, best_i.to(torch.int32), node_max


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(init_req, avail, used_now, inv_alloc, node_static, eligible,
            pods_ok, sig_feas_i8, pars, families):
    from ._build import load

    T, R = init_req.shape
    N = avail.shape[0]
    dev = init_req.device
    f32 = torch.float32
    for name, t, dtype, shape in (
            ("init_req", init_req, f32, (T, R)),
            ("avail", avail, f32, (N, R)),
            ("used_now", used_now, f32, (N, R)),
            ("inv_alloc", inv_alloc, f32, (N, R)),
            ("node_static", node_static, f32, (N,)),
            ("eligible", eligible, f32, (T,)),
            ("pods_ok", pods_ok, f32, (N,)),
            ("sig_feas_i8", sig_feas_i8, torch.int8, (T, N)),
            ("pars", pars, f32, (5 + R,))):
        _check(name, t, dtype, shape, dev)
    if T < 1 or N < 1 or not 2 <= R <= 8:
        raise ValueError(f"fused_choice: unsupported shape T={T} N={N} "
                         f"R={R}")
    unknown = set(families) - set(_FAMILY_BITS)
    if unknown:
        raise ValueError(f"fused_choice: unknown score families {unknown}")
    fam = sum(_FAMILY_BITS[f] for f in set(families))

    lib = load("fused_choice")
    fn = lib.fused_choice_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    best_s = torch.empty((T,), dtype=f32, device=dev)
    best_i = torch.empty((T,), dtype=torch.int32, device=dev)
    node_max = torch.empty((N,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(init_req.data_ptr(), eligible.data_ptr(),
                 sig_feas_i8.data_ptr(), avail.data_ptr(),
                 used_now.data_ptr(), inv_alloc.data_ptr(),
                 node_static.data_ptr(), pods_ok.data_ptr(), pars.data_ptr(),
                 best_s.data_ptr(), best_i.data_ptr(), node_max.data_ptr(),
                 T, N, R, fam, stream)
    if err != 0:
        raise RuntimeError(f"fused_choice kernel launch failed: CUDA error "
                           f"{err}")
    fused_choice.launches += 1
    return best_s, best_i, node_max


def fused_choice(init_req, avail, used_now, inv_alloc, node_static,
                 eligible, pods_ok, sig_feas_i8, pars,
                 families: Tuple[str, ...]):
    """Fused (feasibility & score & argmax & node-max) over [T,N].

    init_req [T,R] f32; avail/used_now/inv_alloc [N,R] f32; node_static
    [N] f32; eligible [T] f32 (0/1); pods_ok [N] f32 (0/1); sig_feas_i8
    [T,N] int8 (round-invariant predicate mask); pars [5+R] f32
    (``pack_pars``). Returns (best_score [T] f32, best_idx [T] int32,
    node_max [N] f32). CPU tensors take the plain version; CUDA tensors
    launch the kernel (``fused_choice.launches`` counts those launches)."""
    dev = init_req.device
    if dev.type == "cpu":
        return fused_choice_plain(init_req, avail, used_now, inv_alloc,
                                  node_static, eligible, pods_ok,
                                  sig_feas_i8, pars, families)
    if dev.type == "cuda":
        return _launch(init_req, avail, used_now, inv_alloc, node_static,
                       eligible, pods_ok, sig_feas_i8, pars, families)
    raise ValueError(f"fused_choice: no implementation for device {dev}")


#: kernel launches made through the wrapper (not the plain version's calls)
fused_choice.launches = 0


def pack_pars(params: Dict[str, torch.Tensor], R: int) -> torch.Tensor:
    """The kernel's flat parameter vector from the solver's score params:
    [binpack_weight, least, most, balanced, 100/sum(w), w_0..w_{R-1}]."""
    w = params["binpack_res_weights"].to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    head = torch.stack([
        params["binpack_weight"].to(torch.float32).reshape(()),
        params["least_req_weight"].to(torch.float32).reshape(()),
        params["most_req_weight"].to(torch.float32).reshape(()),
        params["balanced_weight"].to(torch.float32).reshape(()),
        # tensor / tensor: a python scalar over a tensor would compute
        # reciprocal(wsum) * 100, which is not the correctly rounded quotient
        torch.full_like(wsum, 100.0) / wsum,
    ])
    return torch.cat([head, w[:R]])


def fused_setup(sig_feas, node_alloc, score_params, R: int):
    """The fused path's per-solve prelude: (sig_i8, inv_alloc, pars,
    node_static). ``sig_feas`` is the pre-composed [T,N] bool mask."""
    sig_i8 = sig_feas.to(torch.int8).contiguous()
    inv_alloc = (1.0 / node_alloc).contiguous()
    pars = pack_pars(score_params, R).contiguous()
    node_static = score_params["node_static"].to(torch.float32).contiguous()
    return sig_i8, inv_alloc, pars, node_static
