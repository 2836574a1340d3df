"""The travel-time PINN's forward as one hand-written CUDA kernel.

``csrc/pinn_trv.cu`` evaluates ``TravelTimesPN`` (``models/
travel_time_pinn.py``) for every (source, station) pair with the 50-wide
activations on chip and writes only the ``(…, n_src, n_sta, 2)`` seconds: a
per-source prologue (the normalized source and the embedding branch) and a
persistent pair kernel, two launches a call for any number of sources and
stations. It rounds as the plain forward does on the card (cuBLAS's order of
sums, PyTorch's unfused elementwise ops, libdevice's ``sinf``), so at the
pipeline's shapes the two agree bit for bit. It replaces no TPU kernel (the
JAX package leaves the PINN to XLA); it exists because PyTorch runs the
network op by op through device memory, which is where
differential-evolution location spent its device time.

:func:`pinn_trv` launches it on CUDA tensors and raises on anything it does
not take; :class:`~genie_tpu_torch.models.travel_time_pinn.TravelTimePN`
decides between it and the plain forward (:func:`differentiated`) and
refuses a PINN of other widths (:func:`check_widths`). :func:`pack_weights`
lays the weights out as the kernel reads them. The launch runs inside the
dispatcher operator ``genie_tpu_torch::pinn_trv``, so ``torch.profiler``
links the two kernels to that operator and through it to the ranges around
the call; a launch made straight from Python belongs to no operator, and
its device time falls outside every range. ``pinn_trv.launches`` counts
kernel launches (two a call); while the tracer records, each call adds its
pairs to the counter ``trv.pairs``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F
from torch._C import _functorch

from genie_tpu_torch import tracing

H, NE, NPH = 50, 10, 2      # the widths the kernel is built for
HP = 52                     # a prologue weight row, padded to 16 bytes
NOG, TN, OGW = 4, 13, 16    # a product's output groups, their width and stride
WS = NOG * OGW              # a pair-kernel weight row: output n at column
                            # (n // TN) * OGW + n % TN, zeros elsewhere


def layout(nb: int) -> dict:
    """Offsets (floats) of the packed weights for ``nb`` baseline columns:
    the mirror of ``layout`` in ``csrc/pinn_trv.cu``. Each matrix is
    followed by its bias row."""
    k1, k2 = 3 + nb + NE, 6 + nb + NE
    off = {"a1": 0}
    off["a2"] = off["a1"] + (k1 + 1) * WS
    off["hid"] = off["a2"] + (k2 + 1) * WS
    off["m1a"] = off["hid"] + 4 * (H + 1) * WS
    off["m1b"] = off["m1a"] + H * WS
    off["m2"] = off["m1b"] + (H + 1) * WS
    off["bm2"] = off["m2"] + H * NPH
    off["scales"] = off["bm2"] + 4
    off["main"] = off["scales"] + 8
    off["p31"] = off["main"]
    off["p32"] = off["p31"] + 4 * HP
    off["p33"] = off["p32"] + (H + 1) * HP
    off["p34"] = off["p33"] + (H + 1) * HP
    off["total"] = off["p34"] + (H + 1) * HP
    return off


def pair_flops(nb: int) -> int:
    """FLOP-equivalents of one pair as the plain forward computes it: 2 per
    multiply-add (both first layers over all their inputs, four 50 × 50
    hidden layers, the 100 × 50 merge, the 50 × 2 merge), 1 per bias add,
    residual add or PReLU op, and 20 per ``sinf`` (the ~10 FP32-pipe
    instructions of its fast path, each a slot that could have done a
    2-FLOP multiply-add). The embedding branch, once per source, is left
    out."""
    fma = (3 + nb + NE) * H + (6 + nb + NE) * H + 4 * H * H + 2 * H * H + H * NPH
    adds = 6 * H + 4 * H + 3 * H + NPH
    return 2 * fma + adds + 20 * 6 * H


def n_base(model) -> int:
    """The model's baseline columns: 1, or one per phase with
    ``per_phase_base``."""
    return model.n_phases if model.per_phase_base else 1


def check_widths(model):
    """Raise unless the kernel is built for the model's widths (``H``
    hidden, ``NE`` embedding, ``NPH`` phases)."""
    nb = n_base(model)
    h, ne = model.fc1_2.weight.shape[0], model.fc3_4.weight.shape[0]
    n_ph = model.merge_2.weight.shape[0]
    if not (model.fc1_2.weight.shape == (H, H) and ne == NE and n_ph == NPH
            and model.fc1_1.weight.shape[1] == 3 + nb + NE):
        raise ValueError(
            f"pinn_trv: the kernel is built for {H} hidden, {NE} embedding and {NPH} "
            f"phase outputs; this PINN has {h}, {ne} and {n_ph}. Call "
            f"TravelTimePN.plain_from_cart for it")


def pack_weights(model, scales) -> torch.Tensor:
    """The 1-D float32 buffer the kernel reads (:func:`layout`): every
    matrix transposed to (in, out); the pair kernel's rows ``WS`` wide with
    output n at column ``(n // TN) * OGW + n % TN``, the prologue's ``HP``
    wide; zeros elsewhere. On the model's device."""
    nb = n_base(model)
    dev = model.fc1_1.weight.device
    n = torch.arange(H, device=dev)
    cols = (n // TN) * OGW + n % TN          # the pair kernel's column of output n

    def grouped(w):                  # (in, H) → (in, WS), outputs at their columns
        out = torch.zeros((w.shape[0], WS), dtype=torch.float32, device=dev)
        out[:, cols] = w.detach()
        return out

    def mat(w):                      # nn.Linear weight (out, in) → (in, HP)
        return F.pad(w.detach().t(), (0, HP - w.shape[0]))

    def row(b):
        return F.pad(b.detach(), (0, HP - b.shape[0]))[None]

    def lin(m, to):                  # (in, out) then the bias row
        return [to(m.weight.t()), to(m.bias[None])]

    parts = lin(model.fc1_1, grouped) + lin(model.fc2_1, grouped)
    for m in (model.fc1_2, model.fc1_3, model.fc2_2, model.fc2_3):
        parts += lin(m, grouped)
    m1 = model.merge_1
    parts += [grouped(m1.weight[:, :H].t()), grouped(m1.weight[:, H:].t()),
              grouped(m1.bias[None])]
    parts += [model.merge_2.weight.detach().t()]                     # (H, NPH)
    parts += [torch.cat((model.merge_2.bias.detach(), model.merge_act.a.detach().reshape(1),
                         torch.zeros(1, device=dev)))[None]]
    s = scales
    parts += [torch.cat((s.center, s.x_scale.reshape(1), s.t_scale.reshape(1),
                         s.conversion_factor.reshape(1), s.v_mean)).to(dev)[None]]
    for m in (model.fc3_1, model.fc3_2, model.fc3_3, model.fc3_4):
        parts += [mat(m.weight), row(m.bias)]
    packed = torch.cat([p.reshape(-1).to(torch.float32) for p in parts])
    assert packed.numel() == layout(nb)["total"], (packed.numel(), layout(nb))
    return packed.contiguous()


def differentiated(tensors, params) -> bool:
    """Whether a call on ``tensors`` with the model's ``params`` may be
    differentiated: it runs inside a ``torch.func`` transform (``vmap``,
    ``jacfwd``, ``grad``, …) or a forward-mode ``dual_level``, or autograd
    records and one of them requires a gradient. The kernel has no
    derivative, so such calls take the plain forward."""
    if (_functorch.maybe_current_level() is not None
            or getattr(fwAD, "_current_level", -1) >= 0):
        return True
    return torch.is_grad_enabled() and any(t.requires_grad for t in (*tensors, *params))


def _bind(lib):
    p = ctypes.c_void_p
    ll = ctypes.c_longlong
    i = ctypes.c_int
    lib.pinn_trv_launch.argtypes = [p, p, ll, p, p, p, ll, i, i, p]
    lib.pinn_trv_launch.restype = i
    lib.pinn_trv_packed_floats.argtypes = [i]
    lib.pinn_trv_packed_floats.restype = i
    lib.pinn_trv_rows_floats.argtypes = [ll]
    lib.pinn_trv_rows_floats.restype = ll
    lib.pinn_trv_error_string.argtypes = [i]
    lib.pinn_trv_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    """Build (at first use, beside the port's other sources) and bind
    ``csrc/pinn_trv.cu``."""
    from genie_tpu_torch.ops import _build

    _build.build_all()
    lib = _bind(_build.load("pinn_trv"))
    for nb in (1, NPH):
        if lib.pinn_trv_packed_floats(nb) != layout(nb)["total"]:
            raise RuntimeError("pinn_trv: the library's weight layout differs "
                               "from ops/pinn_trv.py's")
    return lib


_op_library = None


def _operator():
    """``torch.ops.genie_tpu_torch.pinn_trv`` (registered at first use):
    (sta_cart, src rows, packed, nb, lead) → the (*lead, n_sta, 2) times,
    its CUDA kernel :func:`_launch`."""
    global _op_library
    if _op_library is None:
        lib = torch.library.Library("genie_tpu_torch", "FRAGMENT")
        lib.define("pinn_trv(Tensor sta_cart, Tensor src, Tensor packed, int nb, "
                   "int[] lead) -> Tensor")
        lib.impl("pinn_trv", _launch, "CUDA")
        _op_library = lib
    return torch.ops.genie_tpu_torch.pinn_trv


def _launch(sta_cart, src, packed, nb: int, lead):
    dev = sta_cart.device
    n_src, n_sta = src.shape[0], sta_cart.shape[0]
    out = torch.empty((*lead, n_sta, NPH), dtype=torch.float32, device=dev)
    lib = _library()
    rows = torch.empty(int(lib.pinn_trv_rows_floats(n_src)), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pinn_trv_launch(sta_cart.data_ptr(), src.data_ptr(), src.stride(0),
                                  packed.data_ptr(), rows.data_ptr(), out.data_ptr(),
                                  n_src, n_sta, nb, stream)
    if err != 0:
        msg = lib.pinn_trv_error_string(err).decode()
        raise RuntimeError(f"pinn_trv kernel launch failed: CUDA error {err} ({msg})")
    return out


def pinn_trv(sta_cart, src_cart, packed, nb: int):
    """Travel times (…, n_src, n_sta, 2) s of the packed PINN
    (:func:`pack_weights`, ``nb`` baseline columns) from Cartesian stations
    (n_sta, 3), contiguous, and sources (…, 3), whose rows may have a
    stride (the DE's candidates are a slice of (…, 4)) but whose last axis
    must be contiguous. Launches on the current stream."""
    for name, t in (("sta_cart", sta_cart), ("src_cart", src_cart), ("packed", packed)):
        if t.dtype != torch.float32:
            raise TypeError(f"pinn_trv: {name} is {t.dtype}, needs torch.float32")
        if t.device != sta_cart.device:
            raise ValueError(f"pinn_trv: {name} on {t.device}, sta_cart on "
                             f"{sta_cart.device}")
    if sta_cart.dim() != 2 or sta_cart.shape[1] != 3 or src_cart.shape[-1:] != (3,):
        raise ValueError(f"pinn_trv: needs stations (n_sta, 3) and sources (…, 3), got "
                         f"{tuple(sta_cart.shape)} and {tuple(src_cart.shape)}")
    if nb not in (1, NPH) or tuple(packed.shape) != (layout(nb)["total"],):
        raise ValueError(f"pinn_trv: packed weights must be ({layout(nb)['total']},) "
                         f"for nb = {nb}, got {tuple(packed.shape)}")
    if not (sta_cart.is_contiguous() and packed.is_contiguous()):
        raise ValueError("pinn_trv: sta_cart and packed must be contiguous")
    try:
        src = src_cart.view(-1, 3)
    except RuntimeError:
        src = None
    if src is None or (src.shape[0] > 1 and (src.stride(1) != 1 or src.stride(0) < 3)):
        raise ValueError(f"pinn_trv: src_cart's rows must be contiguous, got strides "
                         f"{src_cart.stride()}")
    dev = sta_cart.device
    if dev.type != "cuda":
        raise ValueError(f"pinn_trv: the kernel needs CUDA tensors, got {dev}")
    n_src, n_sta = src.shape[0], sta_cart.shape[0]
    lead = list(src_cart.shape[:-1])
    if n_src == 0 or n_sta == 0:
        return torch.empty((*lead, n_sta, NPH), dtype=torch.float32, device=dev)
    out = _operator()(sta_cart, src, packed, nb, lead)
    pinn_trv.launches += 2
    tracing.count("trv.pairs", n_src * n_sta)
    return out


pinn_trv.launches = 0
