"""The travel-time PINN's hand-written kernel (``ops/pinn_trv.py``,
``csrc/pinn_trv.cu``) and the path rule of ``TravelTimePN.from_cart``.

On the CPU: the plain forward is bit for bit the forward the port had
before the kernel (a frozen copy below), for ``Grids/pinn_nc.pkl`` (one
distance column) and a ``per_phase_base`` model; the packed weights, read at
the kernel's offsets in the kernel's order of sums, give the plain forward's
times; autograd, ``torch.func`` transforms and forward-mode duals take the
plain forward in every caller that differentiates, with today's gradients
and Jacobians; the launcher refuses what the kernel does not take.

On the card (``-m cuda``, skipped without one): the kernel against the
plain forward at the DE's shapes, and differential evolution through either.
No JAX here, so the card's machine runs this file as it is.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from genie_tpu_torch import tracing
from genie_tpu_torch.infer.locate import (location_uncertainty_batched,
                                          locate_sources_batched)
from genie_tpu_torch.models.init import init_pinn
from genie_tpu_torch.models.travel_time_pinn import (TravelTimePN, TravelTimesPN,
                                                     scales_from_domain)
from genie_tpu_torch.ops import pinn_trv
from genie_tpu_torch.params import load_pinn
from genie_tpu_torch.relocation.graphdd import build_catalog_data
from genie_tpu_torch.utils import compute_travel_times_chunked

ROOT = Path(__file__).resolve().parent.parent
PINN = ROOT / "projects/NC_EHZ/Grids/pinn_nc.pkl"

# Kernel against plain forward on the card, seconds. The kernel sums in the
# order cuBLAS takes at the pipeline's shapes, and there the two agree bit
# for bit; at shapes where cuBLAS picks another kernel (a handful of pairs,
# source counts it was not probed at) they differ by float32 rounding
# carried through seven 50-wide layers with sin and scaled by t_scale (139 s
# for pinn_nc.pkl): up to 4.6e-5 s measured before the order was matched,
# the size of the CUDA plain forward's own gap to the CPU (~5e-5 s,
# chip_smoke.py [pinn]).
KERNEL_ATOL_S = 2e-4


def _today_from_cart(tt: TravelTimePN, sta_cart, src_cart):
    """``TravelTimePN.from_cart`` as the port had it before the kernel."""
    s = tt.scales

    def norm(x):
        return (x - s.center) / s.x_scale

    sta_n = norm(sta_cart)
    src_n = norm(src_cart)
    lead = src_n.shape[:-1]
    flat = src_n.reshape(-1, 1, 3)
    step = max(1, tt.max_pairs // max(sta_n.shape[0], 1))
    outs = [tt.model(sta_n, flat[i:i + step], s.conversion_factor, s.v_mean, s.t_scale)
            for i in range(0, flat.shape[0], step)]
    out = torch.cat(outs, dim=0)
    return out.reshape(*lead, sta_n.shape[0], out.shape[-1])


def _per_phase_pinn(device="cpu") -> TravelTimePN:
    model = init_pinn(TravelTimesPN(per_phase_base=True),
                      torch.Generator().manual_seed(7)).requires_grad_(False)
    scales = scales_from_domain(np.array([761.53, 2802.07, -24632.12]), 504000.0,
                                138.66, [6366.0, 3577.9])
    return TravelTimePN(model.to(device), scales.to(device))


def _pinns(device="cpu"):
    return {"pinn_nc": load_pinn(PINN, device=device),
            "per_phase_base": _per_phase_pinn(device)}


@pytest.fixture(scope="module")
def pinns():
    torch.manual_seed(0)
    return _pinns()


def _stations(rng, n):
    return np.stack((rng.uniform(-150e3, 150e3, n), rng.uniform(-200e3, 200e3, n),
                     rng.uniform(-500.0, 1500.0, n)), axis=1).astype(np.float32)


def _sources(rng, *lead):
    n = int(np.prod(lead))
    p = np.stack((rng.uniform(-150e3, 150e3, n), rng.uniform(-200e3, 200e3, n),
                  rng.uniform(-40e3, 0.0, n)), axis=1).astype(np.float32)
    return p.reshape(*lead, 3)


def kernel_twin(sta, src, packed, nb):
    """The kernel's network in float32 PyTorch, reading ``packed`` at the
    kernel's offsets: the per-source prologue (src_n and the embedding),
    each branch's first layer over [rel | base | embed] and [sta_n | src_n |
    base | embed], two hidden layers a branch, merge_1 over p1 then p2,
    PReLU, merge_2, baseline and relu."""
    L = pinn_trv.layout(nb)
    H, HP, NE, WS = pinn_trv.H, pinn_trv.HP, pinn_trv.NE, pinn_trv.WS
    n = torch.arange(H)
    cols = (n // pinn_trv.TN) * pinn_trv.OGW + n % pinn_trv.TN

    def dense(x, off, k, width=H):   # the prologue's (k, HP) rows, then the bias
        w = packed[off:off + (k + 1) * HP].view(k + 1, HP)[:, :width]
        return x @ w[:k] + w[k]

    def gdense(x, off, k):           # the pair kernel's (k, WS) rows, then the bias
        w = packed[off:off + (k + 1) * WS].view(k + 1, WS)[:, cols]
        return x @ w[:k] + w[k]

    sc = packed[L["scales"]:L["scales"] + 8]
    center, xs, ts, cf, vm = sc[:3], sc[3], sc[4], sc[5], sc[6:8]
    src_n = (src.reshape(-1, 3) - center) / xs
    a = torch.sin(dense(src_n, L["p31"], 3))
    for off in (L["p32"], L["p33"]):
        a = torch.sin(dense(a, off, H)) + a
    emb = dense(a, L["p34"], H, NE)
    sta_n = (sta - center) / xs
    rel = sta_n[None] - src_n[:, None]
    d = torch.sqrt((rel ** 2).sum(-1, keepdim=True) + 1e-12)
    base = d if nb == 1 else cf * d / vm
    lead = rel.shape[:-1]
    e = emb[:, None].expand(*lead, NE)
    firsts = (torch.cat((rel, base, e), -1),
              torch.cat((sta_n.expand_as(rel), src_n[:, None].expand_as(rel), base, e), -1))
    branches = []
    for b, (first, off) in enumerate(zip(firsts, (L["a1"], L["a2"]))):
        x = torch.sin(gdense(first, off, first.shape[-1]))
        for j in range(2):
            x = torch.sin(gdense(x, L["hid"] + (2 * b + j) * (H + 1) * WS, H)) + x
        branches.append(x)
    w1 = packed[L["m1a"]:L["m2"]].view(2 * H + 1, WS)[:, cols]
    m = torch.cat(branches, -1) @ w1[:2 * H] + w1[2 * H]
    slope = packed[L["bm2"] + 2]
    h = torch.clamp_min(m, 0) + slope * torch.clamp_max(m, 0)
    pred = h @ packed[L["m2"]:L["bm2"]].view(H, 2) + packed[L["bm2"]:L["bm2"] + 2]
    out = torch.relu((cf * d / vm + pred) * ts)
    return out.reshape(*src.shape[:-1], sta.shape[0], 2)


# -- (a) the plain forward, bit for bit --------------------------------------

@pytest.mark.parametrize("which", ["pinn_nc", "per_phase_base"])
@pytest.mark.parametrize("lead", [(17,), (3, 16)])
def test_plain_forward_is_todays(pinns, which, lead):
    tt = pinns[which]
    rng = np.random.default_rng(1)
    sta = torch.from_numpy(_stations(rng, 23))
    cand = torch.from_numpy(np.concatenate(
        (_sources(rng, *lead), rng.uniform(-5, 5, (*lead, 1)).astype(np.float32)), -1))
    src = cand[..., :3]                        # the DE's strided candidate slice
    with torch.no_grad():
        got = tt.from_cart(sta, src)
        want = _today_from_cart(tt, sta, src)
    assert got.shape == (*lead, 23, 2)
    assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(tt.plain_from_cart(sta, src), want)


def test_plain_forward_chunks_as_today(pinns):
    tt = pinns["pinn_nc"]
    rng = np.random.default_rng(2)
    sta = torch.from_numpy(_stations(rng, 11))
    src = torch.from_numpy(_sources(rng, 40))
    small = TravelTimePN(tt.model, tt.scales)
    small.max_pairs = 50                       # 4 sources a chunk
    with torch.no_grad():
        assert torch.equal(small.from_cart(sta, src), _today_from_cart(small, sta, src))
        assert torch.equal(small.from_cart(sta, src), tt.from_cart(sta, src))


# -- the packed weights, read as the kernel reads them ------------------------

@pytest.mark.parametrize("which", ["pinn_nc", "per_phase_base"])
def test_packed_weights_give_the_plain_forward(pinns, which):
    tt = pinns[which]
    nb = pinn_trv.n_base(tt.model)
    packed = pinn_trv.pack_weights(tt.model, tt.scales)
    assert packed.shape == (pinn_trv.layout(nb)["total"],)
    pinn_trv.check_widths(tt.model)
    rng = np.random.default_rng(3)
    sta = torch.from_numpy(_stations(rng, 37))
    src = torch.from_numpy(_sources(rng, 5, 9))
    with torch.no_grad():
        got = kernel_twin(sta, src, packed, nb)
        want = tt.plain_from_cart(sta, src)
    assert got.shape == want.shape
    # float32, sums in the kernel's order: rounding only
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
    # columns that hold no output are zero, so the padded outputs add nothing
    L = pinn_trv.layout(nb)
    n = torch.arange(pinn_trv.H)
    live = torch.zeros(pinn_trv.WS, dtype=torch.bool)
    live[(n // pinn_trv.TN) * pinn_trv.OGW + n % pinn_trv.TN] = True
    grid = packed[:L["m2"]].view(-1, pinn_trv.WS)
    assert torch.count_nonzero(grid[:, ~live]) == 0


def test_pair_flops_counts_the_network():
    # 16,650 multiply-adds, 652 bias, residual and PReLU ops, 300 sinf at 20
    assert pinn_trv.pair_flops(1) == 2 * 16_650 + 652 + 6_000
    assert pinn_trv.pair_flops(2) == pinn_trv.pair_flops(1) + 2 * 2 * 50


@pytest.mark.parametrize("widths", [dict(n_hidden=32), dict(n_embed=8),
                                    dict(n_phases=3)])
def test_unsupported_widths_raise(widths):
    model = TravelTimesPN(**widths).requires_grad_(False)
    with pytest.raises(ValueError, match="plain_from_cart"):
        pinn_trv.check_widths(model)


# -- (b) the path rule and the derivatives -----------------------------------

def _probe(tt, seen):
    params = list(tt.model.parameters())

    def trv(sta, src):
        seen.append(pinn_trv.differentiated((sta, src), params))
        return tt.from_cart(sta, src)

    return trv


def test_cpu_tensors_take_the_plain_forward(pinns):
    tt = pinns["pinn_nc"]
    sta = torch.zeros(4, 3)
    with torch.no_grad():
        assert tt._kernel_weights(sta, torch.zeros(2, 3)) is None
        assert tt._kernel_weights(sta.double(), torch.zeros(2, 3).double()) is None


def test_differentiated_flags():
    x = torch.randn(5, 3)
    p = [torch.randn(2)]
    with torch.no_grad():
        assert not pinn_trv.differentiated((x, x), p)
        assert not pinn_trv.differentiated((x, x.requires_grad_(True)), p)
    x = torch.randn(5, 3)
    assert not pinn_trv.differentiated((x, x), p)       # grad on, nothing to record
    assert pinn_trv.differentiated((x, x.clone().requires_grad_(True)), p)
    assert pinn_trv.differentiated((x, x), [torch.randn(2, requires_grad=True)])
    seen = []

    def f(v):
        seen.append(pinn_trv.differentiated((v, v), p))
        return v.sin()

    torch.func.vmap(torch.func.jacfwd(f))(x)
    torch.func.jacrev(f)(x[0])
    torch.func.vmap(f)(x)
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        seen.append(pinn_trv.differentiated((fwAD.make_dual(x, x), x), p))
    assert seen == [True] * 4


def test_autograd_through_from_cart_is_todays(pinns):
    tt = pinns["pinn_nc"]
    rng = np.random.default_rng(4)
    sta = torch.from_numpy(_stations(rng, 19))
    src0 = torch.from_numpy(_sources(rng, 6))
    grads = []
    for fn in (tt.from_cart, lambda a, b: _today_from_cart(tt, a, b)):
        src = src0.clone().requires_grad_(True)
        (fn(sta, src) ** 2).sum().backward()
        grads.append(src.grad)
    assert torch.equal(grads[0], grads[1])


def test_covariance_jacfwd_takes_the_plain_forward(pinns):
    tt = pinns["pinn_nc"]
    rng = np.random.default_rng(5)
    sta = torch.from_numpy(_stations(rng, 30))
    pos = torch.from_numpy(_sources(rng, 3))
    t0 = torch.zeros(3)
    ip = torch.from_numpy(rng.integers(0, 30, (3, 8)).astype(np.int32))
    ph = torch.from_numpy(rng.integers(0, 2, (3, 8, 1)).astype(np.float32))
    with torch.no_grad():
        tp = torch.gather(tt.from_cart(sta, pos), 1,
                          ip.long()[..., None].expand(-1, -1, 2))
        tp = torch.gather(tp, 2, ph.long())[..., 0] + 0.05
    mk = torch.ones_like(tp, dtype=torch.bool)
    seen = []
    with torch.no_grad():
        got = location_uncertainty_batched(_probe(tt, seen), sta, pos, t0, tp, ip, ph, mk)
        want = location_uncertainty_batched(lambda a, b: _today_from_cart(tt, a, b),
                                            sta, pos, t0, tp, ip, ph, mk)
    assert seen and all(seen)
    assert torch.equal(got, want)


def test_graphdd_partials_take_the_plain_forward(pinns):
    tt = pinns["per_phase_base"]
    rng = np.random.default_rng(6)
    sta = torch.from_numpy(_stations(rng, 12))
    pos = torch.from_numpy(_sources(rng, 4))
    obs = torch.from_numpy(rng.uniform(5, 40, (4, 12, 2)).astype(np.float32))
    mask = torch.ones(4, 12, 2)
    seen = []
    with torch.no_grad():
        got = build_catalog_data(_probe(tt, seen), sta, pos, torch.zeros(4), obs, mask)
        want = build_catalog_data(lambda a, b: _today_from_cart(tt, a, b), sta, pos,
                                  torch.zeros(4), obs, mask)
    assert seen == [False, True]            # the residuals, then vmap(jacfwd)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_de_location_takes_the_kernel_path_without_grad(pinns):
    tt = pinns["pinn_nc"]
    rng = np.random.default_rng(8)
    sta = torch.from_numpy(_stations(rng, 16))
    tp = torch.from_numpy(rng.uniform(5, 30, (2, 6)).astype(np.float32))
    ip = torch.from_numpy(rng.integers(0, 16, (2, 6)).astype(np.int32))
    ph = torch.zeros(2, 6, 1)
    mk = torch.ones(2, 6, dtype=torch.bool)
    lo = torch.tensor([-150e3, -200e3, -40e3, -10.0])
    hi = torch.tensor([150e3, 200e3, 0.0, 10.0])
    seen = []
    with torch.no_grad():
        locate_sources_batched(torch.Generator().manual_seed(0), _probe(tt, seen), sta,
                               tp, ip, ph, mk, lo, hi, popsize=8, n_iter=3)
    assert seen == [False] * 4


# -- (c) what the launcher refuses --------------------------------------------

def test_launcher_refuses_what_the_kernel_does_not_take(pinns):
    tt = pinns["pinn_nc"]
    packed = pinn_trv.pack_weights(tt.model, tt.scales)
    sta = torch.zeros(8, 3)
    src = torch.zeros(5, 3)
    with pytest.raises(TypeError, match="float32"):
        pinn_trv.pinn_trv(sta.double(), src, packed, 1)
    with pytest.raises(TypeError, match="float32"):
        pinn_trv.pinn_trv(sta, src.double(), packed, 1)
    with pytest.raises(ValueError, match="contiguous"):
        pinn_trv.pinn_trv(torch.zeros(3, 8).t(), src, packed, 1)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        pinn_trv.pinn_trv(sta, torch.zeros(5, 6)[:, ::2], packed, 1)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        pinn_trv.pinn_trv(sta, torch.zeros(3, 5).t(), packed, 1)
    with pytest.raises(ValueError, match="on meta"):
        pinn_trv.pinn_trv(sta, src.to("meta"), packed, 1)
    with pytest.raises(ValueError, match="packed weights"):
        pinn_trv.pinn_trv(sta, src, packed[:-4], 1)
    with pytest.raises(ValueError, match="packed weights"):
        pinn_trv.pinn_trv(sta, src, packed, 2)
    with pytest.raises(ValueError, match=r"\(n_sta, 3\)"):
        pinn_trv.pinn_trv(torch.zeros(8, 2), src, packed, 1)
    with pytest.raises(ValueError, match="CUDA"):
        pinn_trv.pinn_trv(sta, src, packed, 1)


# -- (d), (e) on the card ------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["pinn_nc", "per_phase_base"])
@pytest.mark.parametrize("n_ev,pop,n_sta", [(1, 128, 374), (12, 128, 374),
                                            (256, 128, 374), (12, 128, 32),
                                            (12, 128, 1000), (3, 37, 374), (1, 1, 5)])
def test_cuda_kernel_matches_plain(card, which, n_ev, pop, n_sta):
    tt = _pinns(card)[which]
    rng = np.random.default_rng(n_ev * 1000 + n_sta)
    sta = torch.as_tensor(_stations(rng, n_sta), device=card)
    cand = torch.as_tensor(np.concatenate(
        (_sources(rng, n_ev, pop), np.zeros((n_ev, pop, 1), np.float32)), -1), device=card)
    before = pinn_trv.pinn_trv.launches
    with torch.no_grad():
        got = tt.from_cart(sta, cand[..., :3])
        torch.cuda.synchronize()
        assert pinn_trv.pinn_trv.launches == before + 2
        want = tt.plain_from_cart(sta, cand[..., :3])
    assert got.shape == (n_ev, pop, n_sta, 2)
    err = float((got - want).abs().max())
    assert np.isfinite(err) and err <= KERNEL_ATOL_S, err


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["pinn_nc", "per_phase_base"])
def test_cuda_grid_tables_are_the_plain_forwards(card, which):
    """The set-up's grid tables (chunks of 133 sources, the last of 101, ×
    374 stations) bit for bit: the kernel sums in cuBLAS's order for these
    shapes, and the benchmark's reference builds its tables with the plain
    forward, so a table entry one rounding off moves the sweep."""
    tt = _pinns(card)[which]
    rng = np.random.default_rng(13)
    sta = torch.as_tensor(_stations(rng, 374), device=card)
    grid = torch.as_tensor(_sources(rng, 500), device=card)
    with torch.no_grad():
        got = compute_travel_times_chunked(tt.from_cart, sta, grid)
        want = compute_travel_times_chunked(tt.plain_from_cart, sta, grid)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_cuda_unsupported_widths_raise_on_the_kernel_path(card):
    model = init_pinn(TravelTimesPN(n_hidden=32), torch.Generator().manual_seed(0))
    tt = TravelTimePN(model.requires_grad_(False).to(card), _per_phase_pinn().scales.to(card))
    rng = np.random.default_rng(14)
    sta = torch.as_tensor(_stations(rng, 20), device=card)
    src = torch.as_tensor(_sources(rng, 6), device=card)
    with torch.no_grad(), pytest.raises(ValueError, match="plain_from_cart"):
        tt.from_cart(sta, src)
    with torch.no_grad():
        assert torch.isfinite(tt.plain_from_cart(sta, src)).all()
    src.requires_grad_(True)            # a differentiated call takes the plain forward
    tt.from_cart(sta, src).sum().backward()
    assert torch.isfinite(src.grad).all()


@pytest.mark.cuda
def test_cuda_profiler_links_the_kernel_to_the_range_around_it(card):
    """The launch runs inside a dispatcher operator, so the profiler puts
    the two kernels below it and below a ``record_function`` range around
    the call, as it does for PyTorch's own kernels."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function

    tt = _pinns(card)["pinn_nc"]
    rng = np.random.default_rng(15)
    sta = torch.as_tensor(_stations(rng, 374), device=card)
    src = torch.as_tensor(_sources(rng, 12, 128), device=card)
    with torch.no_grad():
        tt.from_cart(sta, src)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with record_function("trv"):
                tt.from_cart(sta, src)
            torch.cuda.synchronize()

    def below(ev):
        return [k.name for k in ev.kernels] + [n for c in ev.cpu_children for n in below(c)]

    (trv,) = [e for e in prof.events() if e.name == "trv" and e.device_type == DeviceType.CPU]
    names = below(trv)
    assert any("pinn_sources_kernel" in n for n in names), names
    assert any("pinn_pairs_kernel" in n for n in names), names
    assert trv.device_time_total > 0


@pytest.mark.cuda
def test_cuda_kernel_takes_strided_and_empty_sources(card):
    tt = _pinns(card)["pinn_nc"]
    rng = np.random.default_rng(11)
    sta = torch.as_tensor(_stations(rng, 374), device=card)
    src = torch.as_tensor(_sources(rng, 1000, 2), device=card)[:, 1]   # row stride 6
    packed = pinn_trv.pack_weights(tt.model, tt.scales)
    with torch.no_grad():
        got = pinn_trv.pinn_trv(sta, src, packed, 1)
        want = tt.plain_from_cart(sta, src)
        empty = pinn_trv.pinn_trv(sta, src[:0], packed, 1)
    assert float((got - want).abs().max()) <= KERNEL_ATOL_S
    assert empty.shape == (0, 374, 2)


@pytest.mark.cuda
def test_cuda_de_location_on_both_paths(card):
    tt = _pinns(card)["pinn_nc"]
    rng = np.random.default_rng(12)
    n_ev, n_sta, n_pick = 12, 374, 24
    sta = torch.as_tensor(_stations(rng, n_sta), device=card)
    pos = torch.as_tensor(_sources(rng, n_ev), device=card)
    with torch.no_grad():
        t_true = tt.plain_from_cart(sta, pos)
    d = torch.linalg.norm(sta[None, :, :2] - pos[:, None, :2], dim=-1)
    near = torch.topk(-d, n_pick // 2, dim=1).indices
    ip = torch.cat((near, near), 1).to(torch.int32)
    ph = torch.cat((torch.zeros_like(near), torch.ones_like(near)), 1)
    tp = torch.gather(torch.gather(t_true, 1, ip.long()[..., None].expand(-1, -1, 2)), 2,
                      ph[..., None])[..., 0]
    tp = tp + torch.as_tensor(rng.normal(0, 0.1, tp.shape), dtype=torch.float32,
                              device=card)
    mk = torch.ones_like(tp, dtype=torch.bool)
    lo = torch.tensor([-150e3, -200e3, -40e3, -10.0], device=card)
    hi = torch.tensor([150e3, 200e3, 0.0, 10.0], device=card)
    costs = []
    tracing.reset()
    tracing.enable()
    try:
        for fn in (tt.from_cart, tt.plain_from_cart):
            before = pinn_trv.pinn_trv.launches
            with torch.no_grad():
                _, _, c = locate_sources_batched(torch.Generator(device=card).manual_seed(3),
                                                 fn, sta, tp, ip, ph[..., None].float(), mk,
                                                 lo, hi)
            costs.append(c.cpu().numpy())
            launched = pinn_trv.pinn_trv.launches - before
            assert launched == (2 * 151 if fn == tt.from_cart else 0)
        with torch.no_grad():
            location_uncertainty_batched(tt.from_cart, sta, pos, torch.zeros(n_ev, device=card),
                                         tp, ip, ph[..., None].float(), mk)
        counts = tracing.export()["counts"][None]
    finally:
        tracing.record_with_profiler()
        tracing.reset()
    assert counts.get("trv.plain_calls") == 1          # the covariance's jacfwd
    assert counts.get("trv.pairs") == 151 * n_ev * 128 * n_sta
    # 1,536 sources × 374 stations: travel times bit for bit, so the same DE
    np.testing.assert_array_equal(costs[0], costs[1])
