"""The Hunyuan3D-2.0 DiT's norm, modulation, gate and GELU chains as fused
passes (``csrc/dit_fused.cu``), and their plain versions.

Replaces no TPU kernel: XLA fuses these chains in the JAX package. In eager
PyTorch each was a row of launches between the DiT's GEMMs
(:mod:`motion324_tpu_torch.hy3dgen.dit`), each passing the tensor through
device memory, in f32 where a step cast:

- :func:`dit_rmsnorm`, the per-head QK-RMSNorm: eight launches, 128 calls
  a forward of the release DiT (q and k of both streams in the 16 double
  blocks, q and k in the 32 single blocks);
- :func:`dit_modulate`, ``(1 + scale) * layer_norm(x) + shift``: four
  launches, 97 calls (4 a double block, 1 a single block, the last layer);
- :func:`dit_gate`, ``x + gate * y``: two launches, 96 calls;
- :func:`dit_gelu_cat`, ``cat([attn, gelu_tanh(mlp)], -1)``: two passes,
  32 calls.

Each is one launch on a CUDA tensor in bf16 or f32, counted in its
``launches`` (``dit_rmsnorm.launches`` ...), and reads its inputs through
their strides (q and k as views of the qkv GEMM's output, the (B, 1, C)
modulation rows as chunks of their linear's output), so nothing is copied
or expanded first; the output is new and contiguous. The gate and the GELU +
concat equal the plain versions bit for bit; the two norms take their
sums in another order, so a norm may differ by one ulp of the dtype (where
LayerNorm's centering cancels, by the f32 mean's last bit). On any other
device the wrapper computes the plain version, which is the expression the
DiT computed before, kept bit for bit. The kernels read 16-byte vectors: a
CUDA call whose tensors are not 16-byte aligned, or whose widths and strides
are not multiples of 16 bytes, raises (every DiT the repo builds hands over
such rows). They have no backward: a CUDA call that would need one raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from motion324_tpu_torch.ops.flash_attention import _load

__all__ = ["dit_rmsnorm", "dit_modulate", "dit_gate", "dit_gelu_cat",
           "dit_rmsnorm_reference", "dit_modulate_reference",
           "dit_gate_reference", "dit_gelu_cat_reference", "EPS"]

EPS = 1e-6          # both norms' eps, as the released DiT has it
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_RMS_ARGS = [_P] * 3 + [_I] * 4 + [_L] * 3 + [ctypes.c_float, _I, _P]
_MOD_ARGS = [_P] * 4 + [_I] * 3 + [_L] * 4 + [ctypes.c_float, _I, _P]
_GATE_ARGS = [_P] * 4 + [_I] * 3 + [_L] * 5 + [_I, _P]
_GELU_ARGS = [_P] * 3 + [_I] * 4 + [_L] * 4 + [_I, _P]


def dit_rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMS normalisation over the last dim, statistics in f32, eps 1e-6,
    rounded to x's dtype, then times ``scale`` in x's dtype."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + EPS)
    return out.to(x.dtype) * scale.to(x.dtype)


def dit_modulate_reference(x: torch.Tensor, shift: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """``(1 + scale) * layer_norm(x) + shift``, the norm over the last dim
    with eps 1e-6 and no affine."""
    return (1 + scale) * F.layer_norm(x, x.shape[-1:], eps=EPS) + shift


def dit_gate_reference(x: torch.Tensor, gate: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """``x + gate * y``."""
    return x + gate * y


def dit_gelu_cat_reference(attn: torch.Tensor, mlp: torch.Tensor) -> torch.Tensor:
    """``attn`` then the tanh GELU of ``mlp``, along the last dim."""
    return torch.cat([attn, F.gelu(mlp, approximate="tanh")], dim=-1)


def _code(name: str, ts, dims) -> int:
    """The dtype code of CUDA tensors ``ts``: one dtype of ``_DTYPES`` on
    the current device, ``dims`` dims each with a unit last stride, none
    needing a gradient; else raises, saying what is wrong."""
    x = ts[0]
    code = _DTYPES.get(x.dtype)
    dev = x.get_device()
    ok = code is not None and dev == torch._C._cuda_getDevice()
    for t, dim in zip(ts, dims):
        ok = (ok and t.dtype == x.dtype and t.get_device() == dev
              and t.dim() == dim and t.stride()[-1] == 1)
    if not ok:
        _refuse(name, ts, dims)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name} has no backward: call it under "
                           f"torch.no_grad() or inference_mode()")
    return code


def _refuse(name: str, ts, dims) -> None:
    x = ts[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if any(t.dtype != x.dtype or t.device != x.device for t in ts):
        raise TypeError(f"{name} takes its inputs in one dtype on one device, "
                        f"got {[(t.dtype, t.device) for t in ts]}")
    if x.get_device() != torch._C._cuda_getDevice():
        raise ValueError(f"{name}: the inputs lie on {x.device}, not on the "
                         f"current device")
    raise ValueError(f"{name} takes tensors of {dims} dims with a unit last "
                     f"stride, got {[(tuple(t.shape), t.stride()) for t in ts]}")


def _check_vec(name: str, ts, n: int, strides) -> None:
    """Raises unless 16-byte vectors fit: every base 16-byte aligned, the
    last dim ``n`` and every stride multiples of 16 bytes."""
    per16 = 16 // ts[0].element_size()
    if n % per16 or any(s % per16 for s in strides) or any(
            t.data_ptr() % 16 for t in ts):
        raise ValueError(
            f"{name} reads rows in 16-byte vectors: it takes 16-byte aligned "
            f"tensors whose last dim and strides are multiples of {per16} "
            f"elements, got {[(tuple(t.shape), t.stride()) for t in ts]}")


def _done(counter, entry: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    counter.launches += 1


def _stream(x: torch.Tensor) -> int:
    # the current stream's handle without a Stream object
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def dit_rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(B, L, H, D)`` -> RMS-normalised over D, times ``scale`` (D,),
    contiguous. On CUDA one launch that reads x through its strides."""
    if not x.is_cuda:
        return dit_rmsnorm_reference(x, scale)
    if scale.dtype != x.dtype:
        scale = scale.to(x.dtype)
    code = _code("dit_rmsnorm", (x, scale), (4, 1))
    b, l, h, d = x.shape
    sb, sl, sh, _ = x.stride()
    if scale.shape[0] != d:
        raise ValueError(f"dit_rmsnorm takes a ({d},) scale, got "
                         f"{tuple(scale.shape)}")
    _check_vec("dit_rmsnorm", (x, scale), d, (sb, sl, sh))
    out = x.new_empty((b, l, h, d))
    _done(dit_rmsnorm, "m324_dit_rmsnorm", _load(
        "dit_fused", _RMS_ARGS, "dit_rmsnorm").m324_dit_rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), b, l, h, d, sb, sl,
        sh, EPS, code, _stream(x)))
    return out


def dit_modulate(x: torch.Tensor, shift: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``(1 + scale) * layer_norm(x) + shift`` for x ``(B, L, C)`` and the
    ``(B, 1, C)`` rows ``shift`` and ``scale``; contiguous. On CUDA one
    launch that broadcasts the rows in the kernel."""
    if not x.is_cuda:
        return dit_modulate_reference(x, shift, scale)
    code = _code("dit_modulate", (x, shift, scale), (3, 3, 3))
    b, l, c = x.shape
    if shift.shape != (b, 1, c) or scale.shape != (b, 1, c):
        raise ValueError(f"dit_modulate takes ({b}, 1, {c}) shift and scale, "
                         f"got {tuple(shift.shape)}, {tuple(scale.shape)}")
    sxb, sxl, _ = x.stride()
    s_shift, s_scale = shift.stride()[0], scale.stride()[0]
    _check_vec("dit_modulate", (x, shift, scale), c,
               (sxb, sxl, s_shift, s_scale))
    out = x.new_empty((b, l, c))
    _done(dit_modulate, "m324_dit_modulate", _load(
        "dit_fused", _MOD_ARGS, "dit_modulate").m324_dit_modulate(
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), out.data_ptr(), b,
        l, c, sxb, sxl, s_shift, s_scale, EPS, code, _stream(x)))
    return out


def dit_gate(x: torch.Tensor, gate: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """``x + gate * y`` for x, y ``(B, L, C)`` and the ``(B, 1, C)`` row
    ``gate``; contiguous. On CUDA one launch."""
    if not x.is_cuda:
        return dit_gate_reference(x, gate, y)
    code = _code("dit_gate", (x, gate, y), (3, 3, 3))
    b, l, c = x.shape
    if y.shape != x.shape or gate.shape != (b, 1, c):
        raise ValueError(f"dit_gate takes y of x's shape {tuple(x.shape)} and "
                         f"a ({b}, 1, {c}) gate, got {tuple(y.shape)}, "
                         f"{tuple(gate.shape)}")
    sxb, sxl, _ = x.stride()
    syb, syl, _ = y.stride()
    sg = gate.stride()[0]
    _check_vec("dit_gate", (x, gate, y), c, (sxb, sxl, syb, syl, sg))
    out = x.new_empty((b, l, c))
    _done(dit_gate, "m324_dit_gate", _load(
        "dit_fused", _GATE_ARGS, "dit_gate").m324_dit_gate(
        x.data_ptr(), gate.data_ptr(), y.data_ptr(), out.data_ptr(), b, l, c,
        sxb, sxl, syb, syl, sg, code, _stream(x)))
    return out


def dit_gelu_cat(attn: torch.Tensor, mlp: torch.Tensor) -> torch.Tensor:
    """``(B, L, C)`` attn and ``(B, L, M)`` mlp -> ``(B, L, C + M)``: attn,
    then the tanh GELU of mlp. On CUDA one launch."""
    if not attn.is_cuda:
        return dit_gelu_cat_reference(attn, mlp)
    code = _code("dit_gelu_cat", (attn, mlp), (3, 3))
    b, l, c = attn.shape
    m = mlp.shape[2]
    if mlp.shape[:2] != (b, l):
        raise ValueError(f"dit_gelu_cat takes attn and mlp of one (B, L), got "
                         f"{tuple(attn.shape)}, {tuple(mlp.shape)}")
    sab, sal, _ = attn.stride()
    smb, sml, _ = mlp.stride()
    _check_vec("dit_gelu_cat", (attn, mlp), m, (c, sab, sal, smb, sml))
    out = attn.new_empty((b, l, c + m))
    _done(dit_gelu_cat, "m324_dit_gelu_cat", _load(
        "dit_fused", _GELU_ARGS, "dit_gelu_cat").m324_dit_gelu_cat(
        attn.data_ptr(), mlp.data_ptr(), out.data_ptr(), b, l, c, m, sab, sal,
        smb, sml, code, _stream(attn)))
    return out


dit_rmsnorm.launches = 0
dit_modulate.launches = 0
dit_gate.launches = 0
dit_gelu_cat.launches = 0
