"""The fused dual-relation round: hand-written CUDA kernel and plain twin.

Port of the TPU kernel ``genie_tpu/ops/pallas_fused.py::fused_dual_round``
(``_round_kernel``, ``pl.pallas_call`` at :63), generalised just enough to
serve all four dual-relation rounds of the trunk (``DataAggregation`` rounds
1 and 2, ``DataAggregationAssociationPhase`` rounds 1 and 2). For product
row r and station i:

    agg[r, i] = Σ_k w[i, k] · PReLU(z[r, nbr[i, k]], a_sta)
    h1 = [x[r, i] ‖ agg[r, i]     ‖ e_sta[i] ‖ mask[r, i]] @ W1ᵀ + b1
    h2 = [x[r, i] ‖ agg_src[r, i] ‖ e_src[s] ‖ mask[r, i]] @ W2ᵀ + b2
    out[r, i] = PReLU([h1 ‖ h2], a_out)

``(nbr, w)`` is the station kNN table with ``w = valid/deg``: exactly the
nonzeros that ``aggregation_matrix`` puts in the dense ``A_sta``. ``z`` is
``x`` in round 1 of ``DataAggregation`` and the output of the preceding
``Dense`` otherwise; ``agg_src`` (the source-axis mean) arrives precomputed.
The edge tables ``e_sta`` (n_sta, 4) and ``e_src`` (n_src, 4), with ``s``
the row's source, are the edge form of the updated model definition (the
JAX ``DataAggregation(use_edges=True)``, ``layers.py:105-132``, which
concatenates them after the station and source means); without them (run6)
the ``e`` columns are absent.

:func:`fused_round` launches the kernel (``csrc/fused_round.cu``) on CUDA
tensors and raises if it cannot; it takes :func:`fused_round_plain` only for
tensors that lie on the CPU. ``fused_round.launches`` counts kernel launches;
while the tracer records (``genie_tpu_torch.tracing``) each call also leaves
its shape and path there.
Any station count launches: past about 900 stations (H = 30) the kernel's
per-row buffer ``Y = PReLU(z) @ W1a`` no longer fits in shared memory beside
the ring, and the wrapper allocates a per-block scratch for it in device
memory (:func:`kernel_plan` says which plan a shape takes); only shapes
whose weights and ring do not fit (thousands of channels) or H > 32 are
refused.
:class:`FusedRound` wraps it for autograd (training), with the analytic
backward :func:`fused_round_backward_plain` in PyTorch ops.
:func:`fused_dual_round` keeps the JAX signature (dense ``A_sta``, flax
``(in, out)`` weights, three slopes) for parity tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from genie_tpu_torch import tracing
from genie_tpu_torch.ops.segment import dense_to_neighbours, neighbours_to_dense

# Per-block shared-memory limit of an H100 (sm_90), bytes.
MAX_SMEM_PER_BLOCK = 232448


# 0-dim CPU constants: they join CUDA ops as scalars, without a launch.
_ZERO = torch.zeros(())
_HALF = torch.tensor(0.5)


def relu(x):
    """``max(x, 0)`` with JAX's derivative at the tie: 0.5 at x = 0.
    ``torch.maximum`` splits a tie's gradient evenly, in reverse and
    forward mode (``clamp_min`` gives it all to x)."""
    return torch.maximum(x, _ZERO.to(x.dtype))


def prelu(x, a):
    """``max(x, 0) + a·min(x, 0)``, the four ops of a ``clamp_min`` /
    ``clamp_max`` PReLU and bit for bit its values, with JAX's derivative
    at the tie: ``0.5·(1 + a)`` at x = 0 (the clamps would give ``1 + a``).
    Exact zeros reach a PReLU wherever a zero-bias ``Linear`` meets an
    all-zero row, as at flax-default initialisation. Where autograd records
    the op, :class:`_PReLU` takes the gradient in 4-5 kernels (autograd
    through ``maximum``/``minimum`` takes about 13)."""
    if torch.is_grad_enabled() and (x.requires_grad or a.requires_grad):
        return _PReLU.apply(x, a)
    return _PReLU.forward(x, a)


class _PReLU(torch.autograd.Function):
    """:func:`prelu` with its derivative from :func:`_dprelu`, in reverse
    and forward mode (``torch.func`` transforms pass through it)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, a):
        zero = _ZERO.to(x.dtype)
        return torch.maximum(x, zero) + a * torch.minimum(x, zero)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, a = ctx.saved_tensors
        gx = g * _dprelu(x, a) if ctx.needs_input_grad[0] else None
        ga = ((g * torch.minimum(x, _ZERO.to(x.dtype))).sum_to_size(a.shape)
              if ctx.needs_input_grad[1] else None)
        return gx, ga

    @staticmethod
    def jvp(ctx, x_t, a_t):
        x, a = ctx.saved_tensors
        out = torch.zeros_like(x) if x_t is None else x_t * _dprelu(x, a)
        if a_t is not None:
            out = out + a_t * torch.minimum(x, _ZERO.to(x.dtype))
        return out


def fused_round_plain(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2, slopes,
                      e_sta=None, e_src=None):
    """Plain PyTorch twin of the kernel. x (..., n_src, n_sta, Cx); z,
    agg_src (..., n_sta, Cz); mask (..., n_sta, M); nbr/w (n_sta, k); w1/w2
    ``Linear.weight`` layout (H, Cx+Cz+E+M); slopes (2,) = (a_sta, a_out);
    the edge form's e_sta (n_sta, E) and e_src (n_src, E), or neither (E =
    0). Returns (..., n_sta, 2H)."""
    return prelu(_pre_activations(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2,
                                   slopes, e_sta, e_src)[2], slopes[1])


def _pre_activations(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2, slopes,
                     e_sta=None, e_src=None):
    """The plain twin up to its output PReLU: (u1, u2, [h1 ‖ h2])."""
    zp = prelu(z, slopes[0])
    agg_sta = (zp[..., nbr.long(), :] * w[..., None]).sum(dim=-2)
    if e_sta is None:
        u1 = torch.cat((x, agg_sta, mask), dim=-1)
        u2 = torch.cat((x, agg_src, mask), dim=-1)
    else:
        shp = (*x.shape[:-1], e_sta.shape[-1])
        u1 = torch.cat((x, agg_sta, e_sta.expand(shp), mask), dim=-1)
        u2 = torch.cat((x, agg_src, e_src[:, None, :].expand(shp), mask), dim=-1)
    return u1, u2, torch.cat((F.linear(u1, w1, b1), F.linear(u2, w2, b2)), dim=-1)


def _bind(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    lib.fused_round_launch.argtypes = [p] * 15 + [i] * 9 + [ll, p]
    lib.fused_round_launch.restype = ctypes.c_int
    lib.fused_round_smem_bytes.argtypes = [i] * 6
    lib.fused_round_smem_bytes.restype = ll
    lib.fused_round_scratch_bytes.argtypes = [i] * 8
    lib.fused_round_scratch_bytes.restype = ll
    lib.fused_round_plan.argtypes = [i] * 7
    lib.fused_round_plan.restype = ctypes.c_int
    lib.fused_round_error_string.argtypes = [i]
    lib.fused_round_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    """Build (at first use) and bind ``csrc/fused_round.cu``."""
    from genie_tpu_torch.ops import _build

    return _bind(_build.load("fused_round"))


# edge widths the kernel is built for (a template parameter)
KERNEL_EDGE_WIDTHS = (0, 4)


def kernel_plan(n_sta: int, cx: int, cz: int, e: int, m: int, k: int, h: int) -> dict:
    """Where a launch keeps its per-row ``Y = PReLU(z) @ W1a`` buffer and
    its neighbour table: ``"shared"`` memory, or ``"device"`` memory (Y in a
    per-block scratch the wrapper allocates, past about 900 stations at
    H = 30; the table read in place)."""
    f = int(_library().fused_round_plan(n_sta, cx, cz, e, m, k, h))
    return {"table": "shared" if f & 1 else "device",
            "y": "device" if f & 2 else "shared"}


def fused_round(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2, slopes,
                e_sta=None, e_src=None):
    """One fused dual-relation round (see module docstring); arguments as
    :func:`fused_round_plain`. Leading dimensions of x/z/agg_src/mask are
    flattened into rows; with the edge tables, row r reads source
    ``r mod n_src``."""
    if (e_sta is None) != (e_src is None):
        raise ValueError("fused_round: give both edge tables or neither")
    if x.device.type == "cpu":
        if tracing.recording():
            tracing.launch(_launch_shape(x, z, mask, nbr, w1, e_sta), "plain")
        return fused_round_plain(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2,
                                 slopes, e_sta, e_src)
    if x.device.type != "cuda":
        raise ValueError(f"fused_round: unsupported device {x.device}")
    n_sta, cx = x.shape[-2:]
    cz = z.shape[-1]
    m = mask.shape[-1]
    h = w1.shape[0]
    k = nbr.shape[-1]
    lead = x.shape[:-2]
    rows = 1
    for s in lead:
        rows *= int(s)
    e, n_src = 0, 0
    if e_sta is not None:
        e = e_sta.shape[-1]
        n_src = int(x.shape[-3]) if x.dim() >= 3 else -1
        if e not in KERNEL_EDGE_WIDTHS:
            raise ValueError(f"fused_round: kernel takes edge widths "
                             f"{KERNEL_EDGE_WIDTHS}, got {e}")
        if tuple(e_sta.shape) != (n_sta, e) or tuple(e_src.shape) != (n_src, e):
            raise ValueError(f"fused_round: edge tables must be ({n_sta}, {e}) "
                             f"and (n_src = x.shape[-3], {e}), got "
                             f"{tuple(e_sta.shape)} and {tuple(e_src.shape)}")
    w1t = w1.t().contiguous()
    w2t = w2.t().contiguous()
    nbr = nbr.to(torch.int32).contiguous()
    w = w.to(torch.float32).contiguous()
    b1 = b1.contiguous()
    b2 = b2.contiguous()
    slopes = slopes.reshape(2).to(torch.float32).contiguous()
    tensors = dict(x=x, z=z, agg_src=agg_src, mask=mask, nbr=nbr, w=w, w1=w1t,
                   b1=b1, w2=w2t, b2=b2, slopes=slopes)
    if e:
        tensors.update(e_sta=e_sta.contiguous(), e_src=e_src.contiguous())
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"fused_round: {name} on {t.device}, x on {x.device}")
        want = torch.int32 if name == "nbr" else torch.float32
        if t.dtype != want:
            raise TypeError(f"fused_round: {name} is {t.dtype}, needs {want}")
        if not t.is_contiguous():
            raise ValueError(f"fused_round: {name} must be contiguous")
    for name, t, width in (("z", z, cz), ("agg_src", agg_src, cz),
                           ("mask", mask, m)):
        if tuple(t.shape) != (*lead, n_sta, width):
            raise ValueError(f"fused_round: {name} shape {tuple(t.shape)} "
                             f"does not match x {tuple(x.shape)}")
    d = cx + cz + e + m
    if tuple(w1t.shape) != (d, h) or tuple(w2t.shape) != (d, h):
        raise ValueError(f"fused_round: weights must be ({h}, {d}), got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")
    if tuple(b1.shape) != (h,) or tuple(b2.shape) != (h,):
        raise ValueError("fused_round: biases must be (H,)")
    if tuple(nbr.shape) != (n_sta, k) or tuple(w.shape) != (n_sta, k):
        raise ValueError("fused_round: nbr and w must be (n_sta, k)")
    if h > 32:
        raise ValueError(f"fused_round: kernel supports H <= 32, got {h}")
    lib = _library()
    smem = int(lib.fused_round_smem_bytes(n_sta, cx, cz, e, m, h))
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"fused_round: needs {smem} B of shared memory per "
                         f"block, over the {MAX_SMEM_PER_BLOCK} B limit")
    out = torch.empty((*lead, n_sta, 2 * h), dtype=torch.float32, device=x.device)
    e_ptrs = ((tensors["e_sta"].data_ptr(), tensors["e_src"].data_ptr()) if e
              else (None, None))
    with torch.cuda.device(x.device):
        # past about 900 stations Y lives in device memory, one slice per
        # resident block (grid x n_sta x HP floats)
        need = int(lib.fused_round_scratch_bytes(rows, n_sta, cx, cz, e, m, k, h))
        if need < 0:
            raise RuntimeError(f"fused_round: cannot size the launch: CUDA error "
                               f"{-need} ({lib.fused_round_error_string(-need).decode()})")
        scratch = (torch.empty(need // 4, dtype=torch.float32, device=x.device)
                   if need else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_round_launch(
            x.data_ptr(), z.data_ptr(), agg_src.data_ptr(), mask.data_ptr(),
            nbr.data_ptr(), w.data_ptr(), *e_ptrs, w1t.data_ptr(), b1.data_ptr(),
            w2t.data_ptr(), b2.data_ptr(), slopes.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            rows, n_sta, n_src, cx, cz, e, m, k, h, need, stream)
    if err != 0:
        msg = lib.fused_round_error_string(err).decode()
        raise RuntimeError(f"fused_round kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    fused_round.launches += 1
    if tracing.recording():
        tracing.launch(_launch_shape(x, z, mask, nbr, w1, e_sta), "kernel")
    return out


fused_round.launches = 0


def _launch_shape(x, z, mask, nbr, w1, e_sta) -> tuple:
    """(rows, n_sta, n_src, cx, cz, e, m, k, h, z_is_x) of one call."""
    rows = 1
    for s in x.shape[:-2]:
        rows *= int(s)
    return (rows, int(x.shape[-2]), int(x.shape[-3]) if x.dim() >= 3 else 0,
            int(x.shape[-1]), int(z.shape[-1]), 0 if e_sta is None else int(e_sta.shape[-1]),
            int(mask.shape[-1]), int(nbr.shape[-1]), int(w1.shape[0]),
            z.data_ptr() == x.data_ptr() and z.shape == x.shape)


def _dprelu(h, a):
    """d PReLU(h)/dh as autograd takes it through :func:`prelu`: 1 above
    0, ``a`` below and ``0.5·(1 + a)`` at 0, as ``a + (1 - a)·H(h)`` with
    the Heaviside step ``H(0) = 0.5``, whose own derivative is 0 (so a
    second derivative, as the PINN's eikonal loss takes, goes through)."""
    return torch.addcmul(a, 1.0 - a, torch.heaviside(h.detach(), _HALF.to(h.dtype)))


def fused_round_backward_plain(grad_out, x, z, agg_src, mask, nbr, w, w1, b1,
                               w2, b2, slopes, needs=(True,) * 8, e_sta=None,
                               e_src=None):
    """Analytic gradient of :func:`fused_round_plain` given ``grad_out``
    (..., n_sta, 2H). The pre-activations are recomputed from the inputs by
    the plain twin's own ops, so where a pre-activation lies within
    rounding of the PReLU kink the backward takes the plain round's side
    of it (the kernel's forward may round to the other side). The station
    mean's transpose is the transposed dense station matrix (``A[i, j] =
    Σ_k w[i, k]·[nbr[i, k] = j]``): ``d zp = Aᵀ · d agg``. ``needs`` flags
    (x, z, agg_src, w1, b1, w2, b2, slopes); returns their gradients in
    that order, ``None`` where not needed. The edge tables, like ``mask``,
    take no gradient; W1's and W2's edge columns do."""
    cx = x.shape[-1]
    cz = z.shape[-1]
    h = w1.shape[0]
    u1, u2, hcat = _pre_activations(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2,
                                    slopes, e_sta, e_src)
    gh = grad_out * _dprelu(hcat, slopes[1])
    gh1, gh2 = gh[..., :h], gh[..., h:]
    g_x = g_z = g_src = g_w1 = g_b1 = g_w2 = g_b2 = g_sl = None
    lead = tuple(range(gh.dim() - 1))
    if needs[3]:
        g_w1 = gh1.reshape(-1, h).t() @ u1.reshape(-1, u1.shape[-1])
    if needs[4]:
        g_b1 = gh1.sum(dim=lead)
    if needs[5]:
        g_w2 = gh2.reshape(-1, h).t() @ u2.reshape(-1, u2.shape[-1])
    if needs[6]:
        g_b2 = gh2.sum(dim=lead)
    gu1 = gh1 @ w1[:, :cx + cz]          # edge tables and mask take none
    gu2 = gh2 @ w2[:, :cx + cz]
    if needs[0]:
        g_x = gu1[..., :cx] + gu2[..., :cx]
    if needs[2]:
        g_src = gu2[..., cx:]
    g_zp = None
    if needs[1] or needs[7]:
        a_sta = neighbours_to_dense(nbr, w.to(x.dtype), x.shape[-2])
        g_zp = torch.matmul(a_sta.t(), gu1[..., cx:])
    if needs[1]:
        g_z = g_zp * _dprelu(z, slopes[0])
    if needs[7]:
        g_sl = torch.stack(((g_zp * torch.clamp_max(z, 0.0)).sum(),
                            (grad_out * torch.clamp_max(hcat, 0.0)).sum()))
    return g_x, g_z, g_src, g_w1, g_b1, g_w2, g_b2, g_sl


class FusedRound(torch.autograd.Function):
    """:func:`fused_round` with a gradient. The forward launches the kernel
    (CUDA tensors; it raises rather than fall back) or runs the plain twin
    (CPU tensors), exactly as :func:`fused_round`, so ``fused_round.launches``
    counts the forward launches. The backward is
    :func:`fused_round_backward_plain`, PyTorch ops on the saved inputs: the
    JAX package has no backward kernel (its trainer differentiates the plain
    XLA round), so there is no TPU kernel to port for it; a hand-written
    backward waits on a profile that shows this one holding the step back.
    ``mask``, ``nbr``, ``w`` and the edge tables ``e_sta``/``e_src`` (absent
    in the run6 form) take no gradient."""

    @staticmethod
    def forward(ctx, x, z, agg_src, mask, nbr, w, w1, b1, w2, b2, slopes,
                e_sta=None, e_src=None):
        ctx.save_for_backward(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2, slopes,
                              e_sta, e_src)
        return fused_round(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2, slopes,
                           e_sta, e_src)

    @staticmethod
    def backward(ctx, grad_out):
        (x, z, agg_src, mask, nbr, w, w1, b1, w2, b2, slopes, e_sta,
         e_src) = ctx.saved_tensors
        n = ctx.needs_input_grad
        needs = (n[0], n[1], n[2], n[6], n[7], n[8], n[9], n[10])
        g_x, g_z, g_src, g_w1, g_b1, g_w2, g_b2, g_sl = fused_round_backward_plain(
            grad_out.contiguous(), x, z, agg_src, mask, nbr, w, w1, b1, w2, b2,
            slopes, needs, e_sta, e_src)
        return (g_x, g_z, g_src, None, None, None, g_w1, g_b1, g_w2, g_b2, g_sl,
                None, None)


def fused_dual_round(x, agg_src, mask, a_sta, w1, b1, w2, b2, slopes):
    """The JAX kernel's signature: x, agg_src (n_src, n_sta, C); mask
    (n_src, n_sta, M); dense row-stochastic a_sta (n_sta, n_sta); w1/w2 flax
    layout (2C+M, H); slopes (3,) = (act11, act12 [pre-applied], out).
    ``a_sta`` becomes a padded neighbour list whose k is the largest
    nonzero count of any row, so a dense ``A`` stays exact (only slower)."""
    nbr, w = dense_to_neighbours(a_sta)
    return fused_round(x, x, agg_src, mask, nbr, w, w1.t(), b1, w2.t(), b2,
                       slopes[[0, 2]])
