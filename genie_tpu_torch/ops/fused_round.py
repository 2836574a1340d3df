"""The fused dual-relation round: hand-written CUDA kernel and plain twin.

Port of the TPU kernel ``genie_tpu/ops/pallas_fused.py::fused_dual_round``
(``_round_kernel``, ``pl.pallas_call`` at :63), generalised just enough to
serve all four dual-relation rounds of the trunk (``DataAggregation`` rounds
1 and 2, ``DataAggregationAssociationPhase`` rounds 1 and 2). For product
row r and station i:

    agg[r, i] = Σ_k w[i, k] · PReLU(z[r, nbr[i, k]], a_sta)
    h1 = [x[r, i] ‖ agg[r, i]     ‖ mask[r, i]] @ W1ᵀ + b1
    h2 = [x[r, i] ‖ agg_src[r, i] ‖ mask[r, i]] @ W2ᵀ + b2
    out[r, i] = PReLU([h1 ‖ h2], a_out)

``(nbr, w)`` is the station kNN table with ``w = valid/deg``: exactly the
nonzeros that ``aggregation_matrix`` puts in the dense ``A_sta``. ``z`` is
``x`` in round 1 of ``DataAggregation`` and the output of the preceding
``Dense`` otherwise; ``agg_src`` (the source-axis mean) arrives precomputed.

:func:`fused_round` launches the kernel (``csrc/fused_round.cu``) on CUDA
tensors and raises if it cannot; it takes :func:`fused_round_plain` only for
tensors that lie on the CPU. ``fused_round.launches`` counts kernel launches.
:func:`fused_dual_round` keeps the JAX signature (dense ``A_sta``, flax
``(in, out)`` weights, three slopes) for parity tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from genie_tpu_torch.ops.segment import dense_to_neighbours

# Per-block shared-memory limit of an H100 (sm_90), bytes.
MAX_SMEM_PER_BLOCK = 232448


def _prelu(x, a):
    return torch.clamp_min(x, 0.0) + a * torch.clamp_max(x, 0.0)


def fused_round_plain(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2, slopes):
    """Plain PyTorch twin of the kernel. x (..., n_sta, Cx); z, agg_src
    (..., n_sta, Cz); mask (..., n_sta, M); nbr/w (n_sta, k); w1/w2
    ``Linear.weight`` layout (H, Cx+Cz+M); slopes (2,) = (a_sta, a_out).
    Returns (..., n_sta, 2H)."""
    zp = _prelu(z, slopes[0])
    agg_sta = (zp[..., nbr.long(), :] * w[..., None]).sum(dim=-2)
    h1 = F.linear(torch.cat((x, agg_sta, mask), dim=-1), w1, b1)
    h2 = F.linear(torch.cat((x, agg_src, mask), dim=-1), w2, b2)
    return _prelu(torch.cat((h1, h2), dim=-1), slopes[1])


def _bind(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.fused_round_launch.argtypes = [p] * 12 + [i] * 7 + [p]
    lib.fused_round_launch.restype = ctypes.c_int
    lib.fused_round_smem_bytes.argtypes = [i] * 5
    lib.fused_round_smem_bytes.restype = ctypes.c_longlong
    lib.fused_round_error_string.argtypes = [i]
    lib.fused_round_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    """Build (at first use) and bind ``csrc/fused_round.cu``."""
    from genie_tpu_torch.ops import _build

    return _bind(_build.load("fused_round"))


def fused_round(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2, slopes):
    """One fused dual-relation round (see module docstring); arguments as
    :func:`fused_round_plain`. Leading dimensions of x/z/agg_src/mask are
    flattened into rows."""
    if x.device.type == "cpu":
        return fused_round_plain(x, z, agg_src, mask, nbr, w, w1, b1, w2, b2,
                                 slopes)
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
    w1t = w1.t().contiguous()
    w2t = w2.t().contiguous()
    nbr = nbr.to(torch.int32).contiguous()
    w = w.to(torch.float32).contiguous()
    b1 = b1.contiguous()
    b2 = b2.contiguous()
    slopes = slopes.reshape(2).to(torch.float32).contiguous()
    tensors = dict(x=x, z=z, agg_src=agg_src, mask=mask, nbr=nbr, w=w, w1=w1t,
                   b1=b1, w2=w2t, b2=b2, slopes=slopes)
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
    d = cx + cz + m
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
    smem = int(lib.fused_round_smem_bytes(n_sta, cx, cz, m, h))
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"fused_round: needs {smem} B of shared memory per "
                         f"block, over the {MAX_SMEM_PER_BLOCK} B limit")
    out = torch.empty((*lead, n_sta, 2 * h), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_round_launch(
            x.data_ptr(), z.data_ptr(), agg_src.data_ptr(), mask.data_ptr(),
            nbr.data_ptr(), w.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
            w2t.data_ptr(), b2.data_ptr(), slopes.data_ptr(), out.data_ptr(),
            rows, n_sta, cx, cz, m, k, h, stream)
    if err != 0:
        msg = lib.fused_round_error_string(err).decode()
        raise RuntimeError(f"fused_round kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    fused_round.launches += 1
    return out


fused_round.launches = 0


def fused_dual_round(x, agg_src, mask, a_sta, w1, b1, w2, b2, slopes):
    """The JAX kernel's signature: x, agg_src (n_src, n_sta, C); mask
    (n_src, n_sta, M); dense row-stochastic a_sta (n_sta, n_sta); w1/w2 flax
    layout (2C+M, H); slopes (3,) = (act11, act12 [pre-applied], out).
    ``a_sta`` becomes a padded neighbour list whose k is the largest
    nonzero count of any row, so a dense ``A`` stays exact (only slower)."""
    nbr, w = dense_to_neighbours(a_sta)
    return fused_round(x, x, agg_src, mask, nbr, w, w1.t(), b1, w2.t(), b2,
                       slopes[[0, 2]])
