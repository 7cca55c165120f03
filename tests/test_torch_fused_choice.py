"""The port's fused choice (volcano_tpu_torch.ops.fused_choice) against the
JAX package's Pallas kernel and against the port's own dense path.

- On the CPU the wrapper runs the plain PyTorch version. It is held to the
  JAX ``fused_choice`` run in Pallas interpret mode (as tests/test_solver.py
  runs it) at T=40, N=128: scores and node maxima to 1e-6 relative (XLA's
  CPU compiler may contract a multiply and an add into one FMA, which moves
  the last bit), best_idx equal or tied in score.
- The plain version must equal the dense fits_matrix/score_matrix/argmax
  path bit for bit: both paths evaluate the same float operations in the
  same order.
- Tests marked ``cuda`` hold the CUDA kernel to the plain version on the
  card (exact: the kernel is built without FMA contraction); they skip on
  hosts without a GPU. This module imports JAX only inside the test that
  needs it, so on a GPU host without JAX the card's tests run with
  ``python -m pytest --noconftest -m cuda tests/test_torch_fused_choice.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from volcano_tpu_torch.ops import fused_choice as fc
from volcano_tpu_torch.ops import solver as ts
from volcano_tpu_torch.ops.convert import to_torch_params

FAMILIES = [("binpack",), ("kube",), ("binpack", "kube")]
GI = float(2**30)


def make_inputs(seed: int, T: int, N: int, R: int, dup_nodes: bool = True):
    """Seeded kernel inputs as numpy: integer-valued requests (milli-cpu,
    GiB memory, gpu milli) against nodes of which some are full; with
    ``dup_nodes`` every node repeats its left neighbour's state, so argmax
    ties are common and the first-index rule is exercised."""
    rng = np.random.default_rng(seed)
    req = np.zeros((T, R), np.float32)
    req[:, 0] = 1000.0 * rng.integers(1, 4, T)
    req[:, 1] = GI * rng.integers(1, 5, T)
    alloc = np.zeros((N, R), np.float32)
    alloc[:, 0] = 1000.0 * rng.integers(2, 9, N)
    alloc[:, 1] = GI * rng.integers(4, 17, N)
    if R >= 3:
        req[:, 2] = np.where(rng.random(T) < 0.5, 1000.0, 0.0)
        alloc[:, 2] = 1000.0 * rng.integers(0, 3, N)
        alloc[:, 2] = np.where(alloc[:, 2] > 0, alloc[:, 2], 1.0)
    used = np.floor(alloc * rng.random((N, R)) / 1000.0).astype(np.float32)
    used *= 1000.0
    used[:, 1] = GI * np.floor(alloc[:, 1] / GI * rng.random(N))
    if dup_nodes:
        used[1::2] = used[0::2][:used[1::2].shape[0]]
        alloc[1::2] = alloc[0::2][:alloc[1::2].shape[0]]
    avail = (alloc - used).astype(np.float32)
    sig = (rng.random((T, N)) < 0.8).astype(np.int8)
    elig = (rng.random(T) < 0.9).astype(np.float32)
    pods_ok = (rng.random(N) < 0.9).astype(np.float32)
    node_static = np.zeros(N, np.float32)
    node_static[::7] = 5.0
    params = {
        "binpack_weight": np.float32(1.0),
        "binpack_res_weights": np.ones(R, np.float32) * np.float32(1.5),
        "least_req_weight": np.float32(1.0),
        "most_req_weight": np.float32(0.5),
        "balanced_weight": np.float32(1.0),
        "node_static": node_static,
    }
    inv_alloc = (np.float32(1.0) / alloc).astype(np.float32)
    return {"init_req": req, "avail": avail, "used_now": used,
            "inv_alloc": inv_alloc, "node_static": node_static,
            "eligible": elig, "pods_ok": pods_ok, "sig_feas_i8": sig,
            "alloc": alloc}, params


ORDER = ("init_req", "avail", "used_now", "inv_alloc", "node_static",
         "eligible", "pods_ok", "sig_feas_i8")


def port_args(x, params, device="cpu"):
    tp = to_torch_params(params, device)
    pars = fc.pack_pars(tp, x["init_req"].shape[1])
    return [torch.from_numpy(x[k]).to(device) for k in ORDER] + [pars]


def assert_choice_equivalent(res_a, res_b, x, params, families, rtol):
    """best_score / node_max within rtol; best_idx equal, or a different
    index that is feasible and scores the same (within rtol) in b's dense
    score matrix."""
    (sa, ia, ma), (sb, ib, mb) = [[np.asarray(v) for v in r]
                                  for r in (res_a, res_b)]
    np.testing.assert_allclose(sa, sb, rtol=rtol, atol=0)
    np.testing.assert_allclose(ma, mb, rtol=rtol, atol=0)
    diff = np.nonzero(ia != ib)[0]
    if len(diff):
        args = port_args(x, params)
        feas = fc.fused_feasible(*[args[ORDER.index(k)] for k in (
            "init_req", "avail", "eligible", "pods_ok",
            "sig_feas_i8")]).numpy()
        score = fc._score(args[0], args[2], args[3], args[4], args[8],
                          families).numpy()
        for t in diff:
            assert feas[t, ia[t]] and feas[t, ib[t]], t
            s1, s2 = score[t, ia[t]], score[t, ib[t]]
            assert abs(s1 - s2) <= rtol * max(abs(s1), 1.0), (t, s1, s2)


@pytest.mark.parametrize("R", [2, 3])
@pytest.mark.parametrize("families", FAMILIES)
def test_plain_matches_jax_pallas_interpret(families, R):
    import jax.numpy as jnp

    from volcano_tpu.ops.pallas_kernels import fused_choice as j_fused_choice
    from volcano_tpu.ops.pallas_kernels import pack_pars as j_pack_pars

    x, params = make_inputs(seed=11 * R + len(families), T=40, N=128, R=R)
    tp = to_torch_params(params, "cpu")
    np.testing.assert_array_equal(
        fc.pack_pars(tp, R).numpy(), np.asarray(j_pack_pars(params, R)))
    j_res = j_fused_choice(*[jnp.asarray(x[k]) for k in ORDER],
                           j_pack_pars(params, R), families)
    launches = fc.fused_choice.launches
    t_res = fc.fused_choice(*port_args(x, params), families)
    assert fc.fused_choice.launches == launches  # CPU: plain version
    assert t_res[1].dtype == torch.int32
    assert [tuple(v.shape) for v in t_res] == [(40,), (40,), (128,)]
    has = t_res[0].numpy() > fc.NEG * 0.5
    assert has.any() and not has.all()
    assert_choice_equivalent(j_res, t_res, x, params, families, rtol=1e-6)


@pytest.mark.parametrize("families", FAMILIES)
def test_plain_equals_dense_solver_path(families):
    """fused_choice_plain == masked fits_matrix/score_matrix argmax and
    column max, bit for bit."""
    R = 3
    x, params = make_inputs(seed=5, T=64, N=96, R=R)
    args = port_args(x, params)
    best_s, best_i, node_max = fc.fused_choice_plain(*args, families)
    tp = to_torch_params(params, "cpu")
    req = args[0]
    thr = torch.tensor([10.0, 1.0, 10.0])
    scalar_mask = torch.tensor([False, False, True])
    feas = (ts.fits_matrix(req, args[1], thr, scalar_mask)
            & (args[7] != 0) & (args[5] != 0)[:, None]
            & (args[6] != 0)[None, :])
    alloc = torch.from_numpy(x["alloc"])
    score = ts.score_matrix(req, args[1], args[2], alloc, tp, families)
    masked = torch.where(feas, score, fc.NEG)
    assert torch.equal(best_i.long(), torch.argmax(masked, dim=1))
    assert torch.equal(best_s, torch.amax(masked, dim=1))
    assert torch.equal(node_max, torch.amax(masked, dim=0))


def test_first_index_on_ties():
    """Every node identical and node 0 masked out: every eligible task
    picks node 1, the first feasible max; a task with no feasible node
    reports NEG at index 0."""
    x, params = make_inputs(seed=3, T=8, N=40, R=2)
    for k in ("avail", "used_now", "inv_alloc"):
        x[k][:] = x[k][0]
    x["node_static"][:] = 0.0
    x["pods_ok"][:] = 1.0
    x["sig_feas_i8"][:] = 1
    x["sig_feas_i8"][:, 0] = 0
    x["eligible"][:] = 1.0
    x["eligible"][5] = 0.0
    x["init_req"][:] = np.minimum(x["init_req"], x["avail"][0])
    best_s, best_i, _ = fc.fused_choice(*port_args(x, params),
                                        ("binpack", "kube"))
    assert best_i.tolist() == [1] * 5 + [0] + [1] * 2
    assert best_s[5].item() == pytest.approx(fc.NEG)


def test_wrapper_refuses_other_devices():
    x, params = make_inputs(seed=1, T=8, N=16, R=2)
    args = [a.to("meta") for a in port_args(x, params)]
    with pytest.raises(ValueError, match="no implementation"):
        fc.fused_choice(*args, ("binpack",))


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,R", [(40, 128, 2), (37, 45, 3), (1, 1, 2),
                                   (333, 1000, 3)])
@pytest.mark.parametrize("families", FAMILIES)
def test_kernel_equals_plain_on_card(cuda_device, families, T, N, R):
    x, params = make_inputs(seed=T + N + R, T=T, N=N, R=R)
    args = port_args(x, params, cuda_device)
    before = fc.fused_choice.launches
    got = fc.fused_choice(*args, families)
    torch.cuda.synchronize()
    assert fc.fused_choice.launches == before + 1
    want = fc.fused_choice_plain(*args, families)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
