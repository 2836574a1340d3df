"""The fused dual-relation round of the port against the JAX package.

The plain PyTorch twin (what a CPU tensor runs) is held to the Pallas kernel
in interpret mode and to its XLA reference at atol 2e-5 (the tolerance of
tests/test_pallas_fused.py); the round-2 and association forms (z ≠ x,
through the k-neighbour table) are held to the same expressions written with
the JAX package's own ops. The CUDA kernel itself is held to the twin, and
``FusedRound``'s gradient on the card to autograd through the twin, by tests
that need the card. JAX is imported inside the tests that compare
with it, so the card's machine (no JAX) can run this file with ``-m cuda``."""

import numpy as np
import pytest
import torch

from genie_tpu_torch.ops.fused_round import (FusedRound, fused_dual_round, fused_round,
                                             fused_round_plain)
from genie_tpu_torch.ops.segment import (aggregation_matrix, aggregation_weights,
                                         dense_to_neighbours)

ATOL = 2e-5


def _dense_inputs(seed=0, n_src=64, n_sta=16, c=8, m=4, h=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_src, n_sta, c)).astype(np.float32)
    agg_src = rng.normal(size=(n_src, n_sta, c)).astype(np.float32)
    mask = (rng.random((n_src, n_sta, m)) > 0.5).astype(np.float32)
    a_sta = rng.random((n_sta, n_sta)).astype(np.float32)
    a_sta /= a_sta.sum(1, keepdims=True)
    w1 = rng.normal(size=(2 * c + m, h)).astype(np.float32) * 0.3
    b1 = rng.normal(size=(h,)).astype(np.float32)
    w2 = rng.normal(size=(2 * c + m, h)).astype(np.float32) * 0.3
    b2 = rng.normal(size=(h,)).astype(np.float32)
    slopes = np.asarray([0.25, 0.3, 0.15], np.float32)
    return x, agg_src, mask, a_sta, w1, b1, w2, b2, slopes


@pytest.mark.parametrize("seed,n_sta,c,h", [(0, 16, 8, 8), (1, 11, 30, 15)])
def test_plain_matches_jax_reference(seed, n_sta, c, h):
    jnp = pytest.importorskip("jax.numpy")
    from genie_tpu.ops.pallas_fused import fused_dual_round_reference

    args = _dense_inputs(seed, n_sta=n_sta, c=c, h=h)
    want = np.asarray(fused_dual_round_reference(*map(jnp.asarray, args)))
    got = fused_dual_round(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_matches_pallas_kernel_interpret():
    jnp = pytest.importorskip("jax.numpy")
    from jax.experimental.pallas import tpu as pltpu

    from genie_tpu.ops.pallas_fused import fused_dual_round as jax_fused_dual_round

    args = _dense_inputs(2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused_dual_round(*map(jnp.asarray, args)))
    got = fused_dual_round(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _knn_table(rng, n_sta, k, n_invalid=2):
    nbr = np.stack([rng.choice(n_sta, k, replace=False) for _ in range(n_sta)])
    valid = np.ones((n_sta, k), bool)
    valid[rng.choice(n_sta, n_invalid, replace=False), -1] = False
    return nbr.astype(np.int32), valid


def _jax_round(x, z, agg_src, mask, nbr, valid, w1, b1, w2, b2, a_sta, a_out):
    """One round as the JAX layers write it (layers.py:121-125, 128-132,
    311-321): station mean through the package's gather op."""
    import jax.numpy as jnp

    from genie_tpu.ops.segment import mean_sta_axis

    def prelu(v, a):
        return jnp.maximum(v, 0.0) + a * jnp.minimum(v, 0.0)

    agg_sta = mean_sta_axis(prelu(z, a_sta), nbr, valid)
    h1 = jnp.concatenate((x, agg_sta, mask), -1) @ w1 + b1
    h2 = jnp.concatenate((x, agg_src, mask), -1) @ w2 + b2
    return prelu(jnp.concatenate((h1, h2), -1), a_out)


@pytest.mark.parametrize("form", ["round2", "assoc"])
def test_round_forms_match_jax_expressions(form):
    """z ≠ x: round 2 of DataAggregation (input 60, H 15, M 4) and the
    association rounds (M 5), through the (nbr, valid/deg) table."""
    jnp = pytest.importorskip("jax.numpy")
    cx, cz, m, h = {"round2": (60, 30, 4, 15), "assoc": (30, 30, 5, 30)}[form]
    rng = np.random.default_rng(7)
    B, n_src, n_sta, k = 2, 12, 9, 4
    x = rng.normal(size=(B, n_src, n_sta, cx)).astype(np.float32)
    z = rng.normal(size=(B, n_src, n_sta, cz)).astype(np.float32)
    agg_src = rng.normal(size=(B, n_src, n_sta, cz)).astype(np.float32)
    mask = (rng.random((B, n_src, n_sta, m)) > 0.5).astype(np.float32)
    nbr, valid = _knn_table(rng, n_sta, k)
    d = cx + cz + m
    w1, w2 = (rng.normal(size=(d, h)).astype(np.float32) * 0.2 for _ in range(2))
    b1, b2 = (rng.normal(size=(h,)).astype(np.float32) for _ in range(2))
    a_sta, a_out = 0.21, 0.13
    want = np.stack([np.asarray(_jax_round(
        *map(jnp.asarray, (x[b], z[b], agg_src[b], mask[b], nbr, valid,
                           w1, b1, w2, b2)), a_sta, a_out)) for b in range(B)])
    T = torch.from_numpy
    w = aggregation_weights(T(nbr), T(valid))
    got = fused_round(T(x), T(z), T(agg_src), T(mask), T(nbr), w, T(w1.T.copy()),
                      T(b1), T(w2.T.copy()), T(b2), torch.tensor([a_sta, a_out]))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _edge_tables(rng, n_sta, n_src, e=4):
    """Tables of the magnitude of mean_rel_pos_embed's (|e| <= 1, signed)."""
    e_sta = (rng.uniform(-1, 1, (n_sta, e))).astype(np.float32)
    e_src = (rng.uniform(-1, 1, (n_src, e))).astype(np.float32)
    return e_sta, e_src


@pytest.mark.parametrize("form", ["round1", "round2", "assoc"])
def test_edge_round_forms_match_jax_expressions(form):
    """The edge form (updated model definition): e_sta after the station
    mean in h1, e_src after the source mean in h2, as the JAX layers
    concatenate them (layers.py:105-132, 296-321)."""
    jnp = pytest.importorskip("jax.numpy")
    from genie_tpu.ops.segment import mean_sta_axis

    cx, cz, m, h, same = {"round1": (30, 30, 4, 30, True), "round2": (60, 30, 4, 15, False),
                          "assoc": (30, 30, 5, 30, False)}[form]
    rng = np.random.default_rng(8)
    B, n_src, n_sta, k, e = 2, 12, 9, 4, 4
    x = rng.normal(size=(B, n_src, n_sta, cx)).astype(np.float32)
    z = x if same else rng.normal(size=(B, n_src, n_sta, cz)).astype(np.float32)
    agg_src = rng.normal(size=(B, n_src, n_sta, cz)).astype(np.float32)
    mask = (rng.random((B, n_src, n_sta, m)) > 0.5).astype(np.float32)
    nbr, valid = _knn_table(rng, n_sta, k)
    e_sta, e_src = _edge_tables(rng, n_sta, n_src, e)
    d = cx + cz + e + m
    w1, w2 = (rng.normal(size=(d, h)).astype(np.float32) * 0.2 for _ in range(2))
    b1, b2 = (rng.normal(size=(h,)).astype(np.float32) for _ in range(2))
    a_sta, a_out = 0.21, 0.13

    def prelu(v, a):
        return jnp.maximum(v, 0.0) + a * jnp.minimum(v, 0.0)

    es = jnp.broadcast_to(jnp.asarray(e_sta)[None], (n_src, n_sta, e))
    eo = jnp.broadcast_to(jnp.asarray(e_src)[:, None], (n_src, n_sta, e))
    want = []
    for b in range(B):
        agg = mean_sta_axis(prelu(jnp.asarray(z[b]), a_sta), jnp.asarray(nbr),
                            jnp.asarray(valid))
        h1 = jnp.concatenate((x[b], agg, es, mask[b]), -1) @ w1 + b1
        h2 = jnp.concatenate((x[b], agg_src[b], eo, mask[b]), -1) @ w2 + b2
        want.append(np.asarray(prelu(jnp.concatenate((h1, h2), -1), a_out)))
    T = torch.from_numpy
    w = aggregation_weights(T(nbr), T(valid))
    got = fused_round(T(x), T(z), T(agg_src), T(mask), T(nbr), w, T(w1.T.copy()),
                      T(b1), T(w2.T.copy()), T(b2), torch.tensor([a_sta, a_out]),
                      T(e_sta), T(e_src))
    np.testing.assert_allclose(got.numpy(), np.stack(want), atol=ATOL, rtol=0)


def test_aggregation_matrix_matches_jax_and_neighbour_lists_are_exact():
    jnp = pytest.importorskip("jax.numpy")
    from genie_tpu.ops.segment import aggregation_matrix as jax_aggregation_matrix

    rng = np.random.default_rng(3)
    nbr, valid = _knn_table(rng, 10, 4)
    want = np.asarray(jax_aggregation_matrix(jnp.asarray(nbr), 10, jnp.asarray(valid)))
    a = aggregation_matrix(torch.from_numpy(nbr), 10, torch.from_numpy(valid))
    np.testing.assert_allclose(a.numpy(), want, atol=1e-7)
    nb, w = dense_to_neighbours(a)
    x = torch.randn(10, 5, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose((x[nb.long()] * w[..., None]).sum(1).numpy(),
                               (a @ x).numpy(), atol=1e-6)


@pytest.mark.parametrize("op", ["gather_sum", "gather_mean", "gather_mean_sta_axis",
                                "gather_mean_src_axis", "matmul_mean_sta_axis",
                                "matmul_mean_src_axis"])
def test_segment_ops_match_jax(op):
    jnp = pytest.importorskip("jax.numpy")
    import genie_tpu.ops.segment as jseg
    import genie_tpu_torch.ops.segment as tseg

    rng = np.random.default_rng(11)
    n_src, n_sta, c, k = 9, 7, 5, 3
    feat = rng.normal(size=(n_src, n_sta, c)).astype(np.float32)
    if op.startswith("gather_mean_") or op.startswith("matmul_"):
        n = n_src if "src" in op else n_sta
        nbr, valid = _knn_table(rng, n, k)
        if op.startswith("matmul_"):
            a = np.asarray(jseg.aggregation_matrix(jnp.asarray(nbr), n, jnp.asarray(valid)))
            args = (feat, a)
        else:
            args = (feat, nbr, valid)
    else:
        x = feat.reshape(-1, c)[:12]
        nbr, valid = _knn_table(rng, 12, k)
        args = (x, nbr, valid)
    want = np.asarray(getattr(jseg, op)(*map(jnp.asarray, args)))
    got = getattr(tseg, op)(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # a leading window axis carries through the product-graph ops
    if op != "gather_sum" and op != "gather_mean":
        got2 = getattr(tseg, op)(torch.from_numpy(np.stack([args[0], args[0]])),
                                 *map(torch.from_numpy, args[1:])).numpy()
        np.testing.assert_allclose(got2[1], want, atol=1e-6)


def test_knn_with_context_mask_matches_jax():
    jnp = pytest.importorskip("jax.numpy")
    from genie_tpu.ops.knn import knn as jax_knn
    from genie_tpu_torch.ops.knn import knn

    rng = np.random.default_rng(12)
    ctx = rng.normal(size=(20, 3)).astype(np.float32)
    q = rng.normal(size=(6, 3)).astype(np.float32)
    mask = np.ones(20, bool)
    mask[::3] = False
    jidx, jval = jax_knn(jnp.asarray(ctx), jnp.asarray(q), 5, jnp.asarray(mask))
    idx, val = knn(torch.from_numpy(ctx), torch.from_numpy(q), 5, torch.from_numpy(mask))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert mask[idx.numpy()].all()


def test_kernel_wrapper_refuses_unsupported_devices():
    """No silent plain fallback: a tensor that is neither on the CPU nor on
    a CUDA device is refused."""
    t = torch.empty((2, 3, 4), device="meta")
    nbr = torch.zeros((3, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_round(t, t, t, t, nbr, nbr.float(), torch.empty(2, 12, device="meta"),
                    torch.empty(2, device="meta"), torch.empty(2, 12, device="meta"),
                    torch.empty(2, device="meta"), torch.empty(2, device="meta"))


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_build_cache_key_covers_headers(tmp_path, monkeypatch, edit):
    """The library name hashes every file under csrc/, so editing a header
    that a kernel includes (or adding one) rebuilds it; no nvcc needed."""
    from genie_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "k.cuh"\nint f() { return K; }\n')
    (tmp_path / "k.cuh").write_text("#define K 1\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    before = _build.library_path("k")
    assert _build.library_path("k") == before  # stable while nothing changes
    if edit == "header":
        (tmp_path / "k.cuh").write_text("#define K 2\n")
    elif edit == "new_header":
        (tmp_path / "extra.cuh").write_text("#define J 0\n")
    else:
        (tmp_path / "k.cu").write_text('#include "k.cuh"\nint f() { return K + 1; }\n')
    after = _build.library_path("k")
    assert after != before
    assert after.parent == before.parent and after.name.startswith("libk-")


# n_sta, k, leading dims, float offset of every input's storage. They reach
# the kernel's edges: a ragged last chunk of 192 (or 128) stations (37, 129,
# 374, 600), one station, one row, rows not a multiple of the persistent
# grid (133 > 132 SMs; 1000), k = 16 with padded (w = 0) slots, inputs that
# start off a 16-byte line (offset 1: 4-byte copies and scalar loads), and
# the shared-memory fallbacks (600: the round-2 form reads its neighbour
# table from device memory; 1000 and 2048: Y lives in the device-memory
# scratch, the table in shared memory at 1000 and in device memory at 2048).
_CUDA_CASES = [(37, 8, (3, 20), 0), (600, 5, (3, 20), 0), (374, 8, (1,), 0),
               (374, 8, (133,), 0), (129, 16, (1000,), 0), (1, 1, (5,), 0),
               (256, 8, (7, 3), 0), (374, 8, (9,), 1), (1000, 8, (3, 20), 0),
               (1000, 8, (137,), 1), (2048, 8, (133,), 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_sta,k,lead,offset", _CUDA_CASES,
                         ids=[f"sta{c[0]}-k{c[1]}-rows{np.prod(c[2])}-off{c[3]}"
                              for c in _CUDA_CASES])
def test_cuda_kernel_matches_plain(n_sta, k, lead, offset):
    """Needs the card: the hand-written kernel against its plain twin for
    the three round forms plus narrow H = 8 forms (M = 4 and the 5-wide
    mask), f32 with TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    if n_sta > k:
        nbr, valid = _knn_table(rng, n_sta, k)
    else:
        nbr, valid = np.zeros((n_sta, k), np.int32), np.ones((n_sta, k), bool)
    if k == 16:
        valid[:, 12:] = False  # padded slots, as dense_to_neighbours makes them
    nbr = torch.from_numpy(nbr).to(dev)
    w = aggregation_weights(nbr, torch.from_numpy(valid).to(dev))

    def alloc(shape, fill):
        n = int(np.prod(shape))
        flat = torch.empty(n + offset, device=dev)
        t = flat[offset:].view(shape)
        t.copy_(fill(shape))
        return t

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev)

    def bits(shape):
        return (torch.rand(shape, generator=g, device=dev) > 0.5).float()

    for cx, cz, m, h, same in ((30, 30, 4, 30, True), (60, 30, 4, 15, False),
                               (30, 30, 5, 30, False), (8, 8, 4, 8, True),
                               (30, 30, 5, 8, False)):
        x = alloc((*lead, n_sta, cx), randn)
        z = x if same else alloc((*lead, n_sta, cz), randn)
        agg = alloc((*lead, n_sta, cz), randn)
        mask = alloc((*lead, n_sta, m), bits)
        d = cx + cz + m
        ws = [torch.randn(s, generator=g, device=dev) * 0.2
              for s in ((h, d), (h,), (h, d), (h,))]
        args = (x, z, agg, mask, nbr, w, *ws, torch.tensor([0.25, 0.1], device=dev))
        n0 = fused_round.launches
        got = fused_round(*args)
        torch.cuda.synchronize()
        assert fused_round.launches == n0 + 1
        want = fused_round_plain(*args)
        assert float((got - want).abs().max()) <= 1e-4, (cx, cz, m, h)


# n_sta, k, leading dims (the last is n_src), float offset; as _CUDA_CASES
_CUDA_EDGE_CASES = [(37, 8, (3, 20), 0), (600, 5, (2, 20), 0), (374, 8, (16, 500), 0),
                    (1, 1, (5,), 0), (374, 8, (133,), 0), (374, 8, (3, 7), 1),
                    (1000, 8, (2, 70), 0), (2048, 8, (3, 45), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_sta,k,lead,offset", _CUDA_EDGE_CASES,
                         ids=[f"sta{c[0]}-k{c[1]}-lead{'x'.join(map(str, c[2]))}-off{c[3]}"
                              for c in _CUDA_EDGE_CASES])
def test_cuda_edge_kernel_matches_plain(n_sta, k, lead, offset):
    """Needs the card: the kernel's edge form (E = 4, the updated model
    definition) against its plain twin for the three round forms and an
    H = 8 form, f32 with TF32 off, max |kernel - plain| <= 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(1)
    if n_sta > k:
        nbr, valid = _knn_table(rng, n_sta, k)
    else:
        nbr, valid = np.zeros((n_sta, k), np.int32), np.ones((n_sta, k), bool)
    nbr = torch.from_numpy(nbr).to(dev)
    w = aggregation_weights(nbr, torch.from_numpy(valid).to(dev))
    n_src = lead[-1]

    def alloc(shape, fill):
        n = int(np.prod(shape))
        flat = torch.empty(n + offset, device=dev)
        t = flat[offset:].view(shape)
        t.copy_(fill(shape))
        return t

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev)

    def bits(shape):
        return (torch.rand(shape, generator=g, device=dev) > 0.5).float()

    def edges(shape):
        return torch.rand(shape, generator=g, device=dev) * 2.0 - 1.0

    e_sta = alloc((n_sta, 4), edges)
    e_src = alloc((n_src, 4), edges)
    for cx, cz, m, h, same in ((30, 30, 4, 30, True), (60, 30, 4, 15, False),
                               (30, 30, 5, 30, False), (8, 8, 4, 8, True)):
        x = alloc((*lead, n_sta, cx), randn)
        z = x if same else alloc((*lead, n_sta, cz), randn)
        agg = alloc((*lead, n_sta, cz), randn)
        mask = alloc((*lead, n_sta, m), bits)
        d = cx + cz + 4 + m
        ws = [torch.randn(s, generator=g, device=dev) * 0.2
              for s in ((h, d), (h,), (h, d), (h,))]
        args = (x, z, agg, mask, nbr, w, *ws, torch.tensor([0.25, 0.1], device=dev),
                e_sta, e_src)
        n0 = fused_round.launches
        got = fused_round(*args)
        torch.cuda.synchronize()
        assert fused_round.launches == n0 + 1
        want = fused_round_plain(*args)
        assert float((got - want).abs().max()) <= 1e-4, (cx, cz, m, h)
        # the edge columns do reach the output
        no_edges = fused_round_plain(*args[:11], e_sta * 0, e_src * 0)
        assert float((want - no_edges).abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["round1", "round2", "assoc"])
def test_cuda_fused_round_function_launches_and_matches_autograd(form):
    """Needs the card: under autograd ``FusedRound`` launches the kernel
    once per forward, and its backward matches autograd through the plain
    twin on the card within 1e-4 × each input's max |grad| (f32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    cx, cz, m, h, same = {"round1": (30, 30, 4, 30, True),
                          "round2": (60, 30, 4, 15, False),
                          "assoc": (30, 30, 5, 30, False)}[form]
    n_sta, k, rows = 374, 8, 40
    nbr, valid = _knn_table(np.random.default_rng(0), n_sta, k)
    nbr = torch.from_numpy(nbr).to(dev)
    w = aggregation_weights(nbr, torch.from_numpy(valid).to(dev))

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).requires_grad_()

    x = randn(rows, n_sta, cx)
    z = x if same else randn(rows, n_sta, cz)
    agg = randn(rows, n_sta, cz)
    mask = (torch.rand((rows, n_sta, m), generator=g, device=dev) > 0.5).float()
    d = cx + cz + m
    ws = [randn(h, d, scale=0.2), randn(h), randn(h, d, scale=0.2), randn(h)]
    slopes = torch.tensor([0.25, 0.1], device=dev, requires_grad=True)
    args = (x, z, agg, mask, nbr, w, *ws, slopes)
    leaves = [x] + ([] if same else [z]) + [agg, *ws, slopes]
    g_out = torch.randn((rows, n_sta, 2 * h), generator=g, device=dev)
    n0 = fused_round.launches
    out = FusedRound.apply(*args)
    assert fused_round.launches == n0 + 1 and out.requires_grad
    got = torch.autograd.grad(out, leaves, g_out)
    want = torch.autograd.grad(fused_round_plain(*args), leaves, g_out)
    torch.cuda.synchronize()
    assert fused_round.launches == n0 + 1       # the backward launches nothing
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["round1", "round2", "assoc"])
def test_cuda_edge_fused_round_function_matches_autograd(form):
    """Needs the card: ``FusedRound`` in the edge form (E = 4) launches the
    kernel once and its backward, W1's and W2's edge columns included,
    matches autograd through the plain twin within 1e-4 × each input's max
    |grad|; the edge tables take no gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    cx, cz, m, h, same = {"round1": (30, 30, 4, 30, True),
                          "round2": (60, 30, 4, 15, False),
                          "assoc": (30, 30, 5, 30, False)}[form]
    n_sta, k, B, n_src = 374, 8, 2, 20
    nbr, valid = _knn_table(np.random.default_rng(0), n_sta, k)
    nbr = torch.from_numpy(nbr).to(dev)
    w = aggregation_weights(nbr, torch.from_numpy(valid).to(dev))

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).requires_grad_()

    x = randn(B, n_src, n_sta, cx)
    z = x if same else randn(B, n_src, n_sta, cz)
    agg = randn(B, n_src, n_sta, cz)
    mask = (torch.rand((B, n_src, n_sta, m), generator=g, device=dev) > 0.5).float()
    e_sta = torch.rand((n_sta, 4), generator=g, device=dev) * 2 - 1
    e_src = torch.rand((n_src, 4), generator=g, device=dev) * 2 - 1
    d = cx + cz + 4 + m
    ws = [randn(h, d, scale=0.2), randn(h), randn(h, d, scale=0.2), randn(h)]
    slopes = torch.tensor([0.25, 0.1], device=dev, requires_grad=True)
    args = (x, z, agg, mask, nbr, w, *ws, slopes, e_sta, e_src)
    leaves = [x] + ([] if same else [z]) + [agg, *ws, slopes]
    g_out = torch.randn((B, n_src, n_sta, 2 * h), generator=g, device=dev)
    n0 = fused_round.launches
    out = FusedRound.apply(*args)
    assert fused_round.launches == n0 + 1 and out.requires_grad
    got = torch.autograd.grad(out, leaves, g_out)
    want = torch.autograd.grad(fused_round_plain(*args), leaves, g_out)
    torch.cuda.synchronize()
    assert fused_round.launches == n0 + 1
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_cuda_kernel_refuses_shapes_over_shared_memory():
    """Needs the card: a shape whose weights and two ring buffers do not fit
    in a block's shared memory (here 2,000 input channels) is refused before
    any launch, not run on a smaller plan; a station count alone never is
    (Y and the neighbour table move to device memory), and the run6 plan at
    374 stations keeps both in shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from genie_tpu_torch.ops.fused_round import kernel_plan

    dev = torch.device("cuda")
    assert kernel_plan(374, 30, 30, 0, 4, 8, 30) == {"table": "shared", "y": "shared"}
    assert kernel_plan(1000, 30, 30, 0, 4, 8, 30) == {"table": "shared", "y": "device"}
    assert kernel_plan(4096, 30, 30, 4, 5, 8, 30)["y"] == "device"
    n_sta, k, c, m, h = 64, 8, 2000, 4, 30
    x = torch.zeros((2, n_sta, c), device=dev)
    mask = torch.zeros((2, n_sta, m), device=dev)
    nbr = torch.zeros((n_sta, k), dtype=torch.int32, device=dev)
    w = torch.full((n_sta, k), 1.0 / k, device=dev)
    wt = torch.zeros((h, 2 * c + m), device=dev)
    b = torch.zeros(h, device=dev)
    n0 = fused_round.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_round(x, x, x, mask, nbr, w, wt, b, wt, b,
                    torch.tensor([0.25, 0.1], device=dev))
    assert fused_round.launches == n0
