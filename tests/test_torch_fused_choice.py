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
- The kernel's exact rewrites are held here on the CPU: its one-compare
  fit test against ``fused_feasible``, and a numpy model of the packed
  64-bit (score, index) key its epilogue merges node tiles with.
- ``fused_choice_cost`` (the bound's work count) against hand counts.
- Tests marked ``cuda`` hold the CUDA kernel to the plain version on the
  card, bit for bit (the kernel is built without FMA contraction), over
  ``chip_smoke.py``'s edge sweep and with its check: shapes off every
  tile, later-round row masks, ties across node tiles, the fit test's
  boundaries; they skip on hosts without a GPU. This module imports JAX only inside the test that
  needs it, so on a GPU host without JAX the card's tests run with
  ``python -m pytest --noconftest -m cuda tests/test_torch_fused_choice.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
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


@pytest.mark.parametrize("eligible_row", [None, 255])
def test_later_round_masks_match_jax_pallas_interpret(eligible_row):
    """A later round: no row eligible, or only the last of 256. Ineligible
    rows answer (NEG, 0), nodes no eligible row reaches get NEG, and the
    plain version equals the JAX kernel (interpret mode, three node
    tiles of 128) on the same inputs."""
    import jax.numpy as jnp

    from volcano_tpu.ops.pallas_kernels import fused_choice as j_fused_choice
    from volcano_tpu.ops.pallas_kernels import pack_pars as j_pack_pars

    families = ("binpack", "kube")
    x, params = make_inputs(seed=21, T=256, N=384, R=2)
    x["eligible"][:] = 0.0
    if eligible_row is not None:
        x["eligible"][eligible_row] = 1.0
    best_s, best_i, node_max = fc.fused_choice(*port_args(x, params),
                                               families)
    neg = np.float32(fc.NEG)
    inel = x["eligible"] == 0
    assert (best_s.numpy()[inel] == neg).all()
    assert (best_i.numpy()[inel] == 0).all()
    feas = fc.fused_feasible(*[torch.from_numpy(x[k]) for k in (
        "init_req", "avail", "eligible", "pods_ok", "sig_feas_i8")])
    reached = feas.any(dim=0).numpy()
    assert (node_max.numpy()[~reached] == neg).all()
    if eligible_row is None:
        assert not reached.any()
    else:
        assert reached.any() and best_s[eligible_row].item() > neg
    j_res = j_fused_choice(*[jnp.asarray(x[k]) for k in ORDER],
                           j_pack_pars(params, 2), families)
    assert_choice_equivalent(j_res, (best_s, best_i, node_max), x, params,
                             families, rtol=1e-6)


def test_cost_counts_eligible_rows_only():
    """Pair work and mask bytes follow the eligible rows; node terms are
    charged once per node and task terms once per task whatever
    eligible_rows is. Hand counts at T=4, N=3, R=2 (binpack: 12 per pair
    = 2 fit compares, static add, select, row and column max, 2 products,
    1 sum, node term add, weight and scale multiplies; 16 per node, 0 per
    task), the same with both families (42 per pair: kube's 30 with its
    add into the binpack score) and T=5, N=2, R=3 (kube: 36 per pair =
    7 + 29, 12 per node, 1 per task)."""
    # bytes: mask E*N + (req, eligible) + (3 [N,R] + static, pods_ok)
    #        + pars + (best_s, best_i, node_max)
    fixed_bp = 4 * (4 * 2 + 4) + 4 * (3 * 3 * 2 + 2 * 3) + 4 * 7 \
        + 4 * (2 * 4 + 3)
    assert fixed_bp == 216
    for E, ops in ((0, 48), (1, 84), (4, 192)):
        assert fc.fused_choice_cost(4, 3, 2, ("binpack",), E) \
            == (216 + 3 * E, ops)
    assert fc.fused_choice_cost(4, 3, 2, ("binpack",)) \
        == fc.fused_choice_cost(4, 3, 2, ("binpack",), 4)
    assert fc.fused_choice_cost(4, 3, 2, ("binpack", "kube"), 1) \
        == (216 + 3, 3 * 42 + 48)
    assert fc.fused_choice_cost(5, 2, 3, ("kube",), 2) \
        == (2 * 2 + 4 * 20 + 4 * 22 + 4 * 8 + 4 * 12, 2 * 2 * 36 + 24 + 5)
    ms, by = fc.bound_ms(3.35e9, 0)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = fc.bound_ms(0, 33.5e9)
    assert (ms, by) == (pytest.approx(1.0), "operations")


def kernel_fit(init_req, avail):
    """The CUDA kernel's fit test, one compare per dim: rq' <= bound, with
    bound the next float below av + (thr + tol*|av|) (av itself at +-inf;
    NaN, or -inf on a scalar dim, at NaN av) and rq' = -inf where a scalar
    dim's request is <= 10."""
    R = init_req.shape[1]
    thr = torch.tensor([10.0, 1.0] + [10.0] * (R - 2))
    scalar = torch.arange(R) >= 2
    a = avail
    bound = a + (thr + fc.REL_FIT_TOL * torch.abs(a))
    le = torch.where(torch.isnan(a),
                     torch.where(scalar, -torch.inf, a),
                     torch.where(torch.isinf(a), a,
                                 torch.nextafter(bound,
                                                 torch.tensor(-torch.inf))))
    rq = torch.where(scalar & (init_req <= 10.0), -torch.inf, init_req)
    return (rq[:, None, :] <= le[None, :, :]).all(dim=-1)


@pytest.mark.parametrize("R", [2, 3])
def test_kernel_fit_form_equals_plain(R):
    """Requests exactly at, one float below and one above each node's
    threshold and availability, scalar requests around 10, and nodes at
    +inf, -inf and NaN: the kernel's one-compare test decides every pair
    as fused_feasible does."""
    rng = np.random.default_rng(40 + R)
    T, N = 600, 37
    x, _ = make_inputs(seed=R, T=T, N=N, R=R)
    avail = x["avail"]
    for i, v in enumerate((np.inf, -np.inf, np.nan, 0.0, -0.0, 3e38)):
        avail[i, i % R] = v
    thr = np.array([10.0, 1.0] + [10.0] * (R - 2), np.float32)
    req = x["init_req"]
    f32 = np.float32
    with np.errstate(invalid="ignore", over="ignore"):
        bound = (avail + (thr + f32(fc.REL_FIT_TOL) * np.abs(avail))
                 ).astype(f32)
    for t in range(T):
        j = rng.integers(0, N)
        for r in range(R):
            b, a = bound[j, r], avail[j, r]
            pick = (b, np.nextafter(b, f32(-np.inf)),
                    np.nextafter(b, f32(np.inf)), a,
                    np.nextafter(a, f32(np.inf)), f32(10.0),
                    np.nextafter(f32(10.0), f32(np.inf)))[rng.integers(0, 7)]
            if np.isfinite(pick):
                req[t, r] = pick
    ones_t, ones_n = torch.ones(T), torch.ones(N)
    sig = torch.ones((T, N), dtype=torch.int8)
    want = fc.fused_feasible(torch.from_numpy(req), torch.from_numpy(avail),
                             ones_t, ones_n, sig)
    got = kernel_fit(torch.from_numpy(req), torch.from_numpy(avail))
    assert torch.equal(got, want)
    assert 0.05 < want.float().mean().item() < 0.95


def key_encode(score, idx):
    """The kernel's packed key: high word the order-preserving bits of the
    score (-0.0 made +0.0 first), low word 0xFFFFFFFF - idx."""
    u = (np.asarray(score, np.float32) + np.float32(0.0)).view(np.uint32)
    hi = np.where(u >> 31, ~u, u | np.uint32(0x80000000)).astype(np.uint64)
    lo = np.uint64(0xFFFFFFFF) - np.asarray(idx, np.uint64)
    return (hi << np.uint64(32)) | lo


def key_decode(key):
    hi = (key >> np.uint64(32)).astype(np.uint32)
    bits = np.where(hi >> 31, hi ^ np.uint32(0x80000000), ~hi)
    idx = np.uint64(0xFFFFFFFF) - (key & np.uint64(0xFFFFFFFF))
    return bits.astype(np.uint32).view(np.float32), idx.astype(np.int64)


def test_packed_key_merge_is_first_index_argmax():
    """Model of the epilogue's merge: each node tile's first-index best is
    encoded as a key, the keys are max-merged in a shuffled order and
    decoded. That gives the row's highest score and, among equal scores
    (-0.0 and +0.0 included), the lowest index, as argmax does; rows with
    no feasible node give NEG at index 0."""
    rng = np.random.default_rng(7)
    values = np.array([fc.NEG, -0.0, 0.0, 1.5, -2.25, 1.5, 3e5, -3e5],
                      np.float32)
    T, N, tile = 200, 96, 16
    rows = values[rng.integers(0, len(values), (T, N))]
    rows[:20] = np.float32(fc.NEG)                  # no feasible node
    rows[20:40, :] = rng.choice(np.array([-0.0, 0.0], np.float32), (20, N))
    for t in range(T):
        keys = []
        for n0 in range(0, N, tile):
            part = rows[t, n0:n0 + tile]
            k = int(np.argmax(part))                # first index in tile
            keys.append(key_encode(part[k], n0 + k))
        order = rng.permutation(len(keys))
        merged = np.uint64(0)
        for o in order:
            merged = max(merged, keys[o])
        score, idx = key_decode(np.array([merged], np.uint64))
        want = int(np.argmax(rows[t]))
        assert idx[0] == want, t
        assert score[0] == rows[t, want], t
    score, idx = key_decode(key_encode(values, np.arange(len(values))))
    assert (score == values).all() and (idx == np.arange(len(values))).all()


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
@pytest.mark.parametrize("T,N,R,variant", chip_smoke.EDGE_CASES)
@pytest.mark.parametrize("families", FAMILIES)
def test_kernel_equals_plain_on_card(cuda_device, families, T, N, R,
                                     variant):
    """best_score, node_max and best_idx on every row (ties included)
    equal the plain version's bit for bit, over chip_smoke.py's edge
    sweep."""
    args = chip_smoke.kernel_inputs(T + N + R, T, N, R, cuda_device,
                                    variant=variant)
    chip_smoke.check_choice(args, families, f"T={T} N={N} R={R} {variant}")
