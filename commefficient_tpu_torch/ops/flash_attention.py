"""Causal flash attention: CUDA kernels for Hopper + their plain versions
(port of ``commefficient_tpu/ops/flash_attention.py``).

Three kernels in ``csrc/flash_attention.cu`` replace the reference's three
Pallas kernels, each behind a wrapper that counts its launches:

* ``flash_fwd`` (``_fwd_kernel``): the online-softmax forward, ``O`` in the
  input dtype and the per-row logsumexp ``lse`` in float32;
* ``flash_bwd_dq`` (``_bwd_dq_kernel``) and ``flash_bwd_dkv``
  (``_bwd_dkv_kernel``): the FlashAttention-2 backward, P recomputed from
  q, k and lse; ``delta = rowsum(dO * O)`` is computed in PyTorch between
  them, as the reference computes it outside its kernels.

All three kernels multiply on the tensor cores: float32 in "3xTF32"
(``csrc/mma_tf32x3.cuh``: each operand split into a TF32 part and a
remainder, three products, float32's accuracy at up to 165 TFLOP/s
effective against the CUDA cores' 67), bfloat16 in one TF32 product,
which holds its values exactly; tiles arrive by 16-byte ``cp.async``
copies that overlap the products, so they need q, k, v and dO 16-byte
aligned. The first port's scalar kernels stay behind ``flash_fwd_v1``,
``flash_bwd_dq_v1`` and ``flash_bwd_dkv_v1`` (keys ``flash_fwd_v1``,
``flash_bwd_dq_v1``, ``flash_bwd_dkv_v1``) to be held against the plain
versions and timed beside the new kernels; no path calls them.

``flash_attention`` is a ``torch.autograd.Function`` over the three (on a
CPU tensor, the plain forward under autograd).

Dropout on the attention probabilities (``dropout_rate`` > 0) keeps the
reference's contract: the softmax denominator sums the undropped
probabilities, which are then scaled by ``keep / (1 - rate)`` before
``p @ V``, and the backward regenerates the same keep bits. The bits of
element (bh, i, j) are the reference's interpret-mode counter hash
(``_hash_bits``) of its place in the reference's LOGICAL tiling, ``(BQ,
BK) = _effective_blocks(T, block_q, block_k)``, under that tile's seed
words. So the kernels' mask equals ``dropout_keep_reference`` (and the
JAX package's) bit for bit, whatever tile the CUDA kernels use.

A head-sharded call (tensor parallelism, ``parallel/tp.py``) holds heads
``[h0, h0 + H_loc)`` of ``H``: its rows are (batch, local head) pairs, and
``heads=(h0, H_loc, H)`` makes local row ``b * H_loc + h`` draw the bits of
global row ``b * H + h0 + h``, so each head keeps the mask it has in the
unsharded call. ``heads=None`` is ``(0, 1, 1)``, the row itself.

The plain versions are the dense causal softmax with the same mask and
the same normalize-then-drop order (``flash_fwd_plain``), and that
forward's autograd (``flash_bwd_plain``). A CPU tensor takes them; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from commefficient_tpu_torch.ops import cuda_lib
from commefficient_tpu_torch.ops.dropout import counter_hash, seed_words
from commefficient_tpu_torch.ops.dropout import hw_threshold as _threshold
from commefficient_tpu_torch.utils.params import round_up

_NEG = -1e30
DEFAULT_BLOCK_Q = 2048
DEFAULT_BLOCK_K = 512
# the reference's per-tile seed mixing constants, as signed int32
_MIX_B = -1640531527       # 0x9E3779B9
_MIX_QB = -2048144777      # 0x85EBCA77
_MIX_KB = -1028477379      # 0xC2B2AE3D
_MIX_B2 = 668265263        # 0x27D4EB2F
_MASK32 = 0xFFFFFFFF
#: the widest head the CUDA kernels are built for
MAX_HEAD_DIM = 128

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_TAIL = [_I, _I, _I, _I, _F, _I, _I, _I, _I, _U, _F, _I, _I, _I, _I, _P]
_SIGNATURES = {
    "flash_fwd_launch": [_P] * 5 + _TAIL,
    "flash_fwd_v1_launch": [_P] * 5 + _TAIL,
    "flash_bwd_dq_launch": [_P] * 7 + _TAIL,
    "flash_bwd_dq_v1_launch": [_P] * 7 + _TAIL,
    "flash_bwd_dkv_launch": [_P] * 8 + _TAIL,
    "flash_bwd_dkv_v1_launch": [_P] * 8 + _TAIL,
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supported(q, k, v, causal: bool, kv_mask) -> bool:
    """Whether the fused kernels take this call: causal self-attention
    without a key mask, equal shapes, a head dim that is a multiple of 8
    and at most ``MAX_HEAD_DIM``, and float32 or bfloat16 throughout."""
    B, Tq, H, D = q.shape
    return (causal and kv_mask is None and k.shape == v.shape
            and q.shape[::2] == k.shape[::2] and D % 8 == 0
            and D <= MAX_HEAD_DIM
            and q.dtype in _DTYPES and q.dtype == k.dtype == v.dtype
            and Tq == k.shape[1])


def _effective_blocks(t: int, block_q: int, block_k: int):
    """The reference kernels' (bq, bk): clamped to T and rounded up to a
    multiple of 16. They define the dropout tiles."""
    tile = lambda x: round_up(max(x, 8), 16)
    return tile(min(block_q, t)), tile(min(block_k, t))


def head_rows(batch_heads: int, heads=None, device="cpu") -> torch.Tensor:
    """(batch_heads,) int64: the global row each local row draws its bits
    from under the head map ``heads = (h0, H_loc, H)`` (None: itself)."""
    b = torch.arange(batch_heads, dtype=torch.int64, device=device)
    if heads is None:
        return b
    h0, h_loc, h_tot = (int(x) for x in heads)
    return (b // h_loc) * h_tot + h0 + b % h_loc


def dropout_keep_reference(seeds, batch_heads: int, t: int, *,
                           dropout_rate: float,
                           block_q: int = DEFAULT_BLOCK_Q,
                           block_k: int = DEFAULT_BLOCK_K,
                           device="cpu", heads=None) -> torch.Tensor:
    """The (batch_heads, Tq_pad, Tk_pad) bool keep mask of the reference's
    interpret-mode kernels for the seed words ``seeds`` (two int32, as the
    reference's ``_seeds_from_key`` makes them), padded per
    ``_effective_blocks``; ``heads`` the head map of a head-sharded call.
    uint32 arithmetic runs in int64 halves."""
    s0_in, s1_in = (int(s) for s in seeds)
    bq, bk = _effective_blocks(t, block_q, block_k)
    tq, tk = -(-t // bq) * bq, -(-t // bk) * bk
    kw = dict(dtype=torch.int64, device=device)
    b = head_rows(batch_heads, heads, device)
    qb = torch.arange(tq // bq, **kw)
    kb = torch.arange(tk // bk, **kw)
    s0 = (s0_in + b[:, None] * _MIX_B + qb[None, :] * _MIX_QB) & _MASK32
    s1 = (s1_in + kb[None, :] * _MIX_KB + b[:, None] * _MIX_B2) & _MASK32
    s0 = torch.repeat_interleave(s0, bq, dim=1)          # (BH, tq)
    s1 = torch.repeat_interleave(s1, bk, dim=1)          # (BH, tk)
    r = torch.arange(tq, **kw) % bq
    c = torch.arange(tk, **kw) % bk
    x = counter_hash(r[None, :, None], c[None, None, :], s0[:, :, None],
                     s1[:, None, :])                      # (BH, tq, tk)
    return x >= _threshold(float(dropout_rate))


def _keep(seeds, bh, t, rate, block_q, block_k, device, heads=None):
    return dropout_keep_reference(seeds, bh, t, dropout_rate=rate,
                                  block_q=block_q, block_k=block_k,
                                  device=device, heads=heads)[:, :t, :t]


def flash_fwd_plain(q3, k3, v3, seeds, scale: float, block_q: int,
                    block_k: int, rate: float, heads=None):
    """Plain version of ``flash_fwd``: dense causal softmax in float32,
    normalized then dropped, p rounded to the input dtype before ``p @ V``
    as the kernel rounds it. Returns ``(O, lse)``; differentiable."""
    bh, t, _ = q3.shape
    dtype = q3.dtype
    s = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
    pos = torch.arange(t, device=q3.device)
    s = torch.where(pos[None, :] <= pos[:, None], s, _NEG)
    m = torch.amax(s, dim=-1, keepdim=True).detach()
    p = torch.exp(torch.clamp(s - m, max=0.0))
    p = torch.where(s <= _NEG / 2, 0.0, p)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    if rate > 0.0:
        keep = _keep(seeds, bh, t, rate, block_q, block_k, q3.device,
                     heads)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    p = p.to(dtype).float()
    o = (p @ v3.float()) / l
    lse = torch.where(m <= _NEG / 2, _NEG, m + torch.log(l))[..., 0]
    return o.to(dtype), lse


def flash_bwd_plain(q3, k3, v3, do, seeds, scale: float, block_q: int,
                    block_k: int, rate: float, heads=None):
    """Plain version of the backward: the autograd of ``flash_fwd_plain``.
    Returns ``(dq, dk, dv)``."""
    with torch.enable_grad():
        q, k, v = (x.detach().requires_grad_(True) for x in (q3, k3, v3))
        o, _ = flash_fwd_plain(q, k, v, seeds, scale, block_q, block_k,
                               rate, heads)
        return torch.autograd.grad(o, (q, k, v), do)


def _check(name, tensors, aligned=False):
    ref = tensors[0]
    if ref.dim() != 3:
        raise ValueError(f"{name}: takes (BH, T, D) tensors, got "
                         f"{tuple(ref.shape)}")
    bh, t, d = ref.shape
    if ref.dtype not in _DTYPES or d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16 "
                         f"with a head dim that is a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {ref.dtype} D={d}")
    for x in tensors:
        if x.device != ref.device or x.dtype != ref.dtype \
                or x.shape != ref.shape or not x.is_contiguous():
            raise ValueError(f"{name}: q, k, v (and dO) must be contiguous "
                             f"tensors of one shape, dtype and device")
        if aligned and x.data_ptr() % 16:
            raise ValueError(f"{name}: the tensor-core kernel copies rows "
                             f"16 bytes at a time and needs q, k, v (and "
                             f"dO) 16-byte aligned")
    return bh, t, d


def _drop_args(seeds, t, block_q, block_k, rate, heads, bh):
    bq, bk = _effective_blocks(t, block_q, block_k)
    s0, s1 = (int(s) for s in seeds)
    h0, h_loc, h_tot = (0, 1, 1) if heads is None else \
        (int(x) for x in heads)
    if h_loc <= 0 or bh % h_loc or h0 < 0 or h0 + h_loc > h_tot:
        raise ValueError(f"head map {heads} does not fit {bh} rows")
    return [bq, bk, s0, s1, _threshold(rate) if rate > 0 else 0,
            1.0 / (1.0 - rate), int(rate > 0), h0, h_loc, h_tot]


def _device_of(fn_name, x):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {x.device}")
    return True


def _launch_fwd(entry, key, q3, k3, v3, seeds, scale, block_q, block_k,
                rate, aligned, heads=None):
    bh, t, d = _check(key, (q3, k3, v3), aligned)
    o = torch.empty_like(q3)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q3.device)
    lib = cuda_lib.load("flash_attention", _SIGNATURES)
    err = getattr(lib, entry)(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, t, d, _DTYPES[q3.dtype], scale,
        *_drop_args(seeds, t, block_q, block_k, rate, heads, bh),
        cuda_lib.stream_ptr(q3.device))
    cuda_lib.check(err, key)
    cuda_lib.LAUNCHES[key] += 1
    return o, lse


def flash_fwd(q3, k3, v3, seeds, scale: float, block_q: int, block_k: int,
              rate: float, heads=None):
    """``(O, lse)`` of causal attention over (BH, T, D) q, k, v; ``heads``
    the head map of a head-sharded call (the module docstring).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    tensor-core kernel or raises."""
    if not _device_of("flash_fwd", q3):
        return flash_fwd_plain(q3, k3, v3, seeds, scale, block_q, block_k,
                               rate, heads)
    return _launch_fwd("flash_fwd_launch", "flash_fwd", q3, k3, v3, seeds,
                       scale, block_q, block_k, rate, True, heads)


def flash_fwd_v1(q3, k3, v3, seeds, scale: float, block_q: int,
                 block_k: int, rate: float, heads=None):
    """``flash_fwd`` by the first port's scalar kernel (on no path)."""
    if not _device_of("flash_fwd_v1", q3):
        return flash_fwd_plain(q3, k3, v3, seeds, scale, block_q, block_k,
                               rate, heads)
    return _launch_fwd("flash_fwd_v1_launch", "flash_fwd_v1", q3, k3, v3,
                       seeds, scale, block_q, block_k, rate, False, heads)


def _bwd_inputs(name, q3, k3, v3, do, lse, delta, aligned=False):
    bh, t, d = _check(name, (q3, k3, v3, do), aligned)
    for x in (lse, delta):
        if x.dtype != torch.float32 or tuple(x.shape) != (bh, t) \
                or x.device != q3.device or not x.is_contiguous():
            raise ValueError(f"{name}: lse and delta must be contiguous "
                             f"float32 ({bh}, {t}) tensors")
    return bh, t, d


def _launch_dq(entry, key, q3, k3, v3, do, lse, delta, seeds, scale,
               block_q, block_k, rate, aligned, heads=None):
    bh, t, d = _bwd_inputs(key, q3, k3, v3, do, lse, delta, aligned)
    dq = torch.empty_like(q3)
    lib = cuda_lib.load("flash_attention", _SIGNATURES)
    err = getattr(lib, entry)(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t, d,
        _DTYPES[q3.dtype], scale,
        *_drop_args(seeds, t, block_q, block_k, rate, heads, bh),
        cuda_lib.stream_ptr(q3.device))
    cuda_lib.check(err, key)
    cuda_lib.LAUNCHES[key] += 1
    return dq


def flash_bwd_dq(q3, k3, v3, do, lse, delta, seeds, scale: float,
                 block_q: int, block_k: int, rate: float, heads=None):
    """dq of causal attention from the forward's ``lse`` and ``delta =
    rowsum(dO * O)``. A CPU tensor takes the plain version (which needs
    neither); a CUDA tensor launches the tensor-core kernel or raises."""
    if not _device_of("flash_bwd_dq", q3):
        return flash_bwd_plain(q3, k3, v3, do, seeds, scale, block_q,
                               block_k, rate, heads)[0]
    return _launch_dq("flash_bwd_dq_launch", "flash_bwd_dq", q3, k3, v3, do,
                      lse, delta, seeds, scale, block_q, block_k, rate,
                      True, heads)


def flash_bwd_dq_v1(q3, k3, v3, do, lse, delta, seeds, scale: float,
                    block_q: int, block_k: int, rate: float, heads=None):
    """``flash_bwd_dq`` by the first port's scalar kernel (on no path)."""
    if not _device_of("flash_bwd_dq_v1", q3):
        return flash_bwd_plain(q3, k3, v3, do, seeds, scale, block_q,
                               block_k, rate, heads)[0]
    return _launch_dq("flash_bwd_dq_v1_launch", "flash_bwd_dq_v1", q3, k3,
                      v3, do, lse, delta, seeds, scale, block_q, block_k,
                      rate, False, heads)


def _launch_dkv(entry, key, q3, k3, v3, do, lse, delta, seeds, scale,
                block_q, block_k, rate, aligned, heads=None):
    bh, t, d = _bwd_inputs(key, q3, k3, v3, do, lse, delta, aligned)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    lib = cuda_lib.load("flash_attention", _SIGNATURES)
    err = getattr(lib, entry)(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        t, d, _DTYPES[q3.dtype], scale,
        *_drop_args(seeds, t, block_q, block_k, rate, heads, bh),
        cuda_lib.stream_ptr(q3.device))
    cuda_lib.check(err, key)
    cuda_lib.LAUNCHES[key] += 1
    return dk, dv


def flash_bwd_dkv(q3, k3, v3, do, lse, delta, seeds, scale: float,
                  block_q: int, block_k: int, rate: float, heads=None):
    """(dk, dv) of causal attention by the tensor-core kernel; as
    ``flash_bwd_dq``."""
    if not _device_of("flash_bwd_dkv", q3):
        return flash_bwd_plain(q3, k3, v3, do, seeds, scale, block_q,
                               block_k, rate, heads)[1:]
    return _launch_dkv("flash_bwd_dkv_launch", "flash_bwd_dkv", q3, k3, v3,
                       do, lse, delta, seeds, scale, block_q, block_k, rate,
                       True, heads)


def flash_bwd_dkv_v1(q3, k3, v3, do, lse, delta, seeds, scale: float,
                     block_q: int, block_k: int, rate: float, heads=None):
    """``flash_bwd_dkv`` by the first port's scalar kernel (on no path)."""
    if not _device_of("flash_bwd_dkv_v1", q3):
        return flash_bwd_plain(q3, k3, v3, do, seeds, scale, block_q,
                               block_k, rate, heads)[1:]
    return _launch_dkv("flash_bwd_dkv_v1_launch", "flash_bwd_dkv_v1", q3,
                       k3, v3, do, lse, delta, seeds, scale, block_q,
                       block_k, rate, False, heads)


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: residuals are q, k, v, O and
    lse (O(T) beyond the inputs); the backward recomputes P."""

    @staticmethod
    def forward(ctx, q3, k3, v3, seeds, scale, block_q, block_k, rate,
                heads):
        o, lse = flash_fwd(q3, k3, v3, seeds, scale, block_q, block_k, rate,
                           heads)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.cfg = (seeds, scale, block_q, block_k, rate, heads)
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # the softmax Jacobian's rank-1 term; dropout leaves it unchanged
        delta = torch.sum(do.float() * o.float(), dim=-1)
        dq = flash_bwd_dq(q3, k3, v3, do, lse, delta, *ctx.cfg)
        dk, dv = flash_bwd_dkv(q3, k3, v3, do, lse, delta, *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    dropout_rate: float = 0.0,
                    dropout_seed=None, head_offset: int = 0,
                    num_heads=None) -> torch.Tensor:
    """Fused causal self-attention, (B, T, H, D) -> (B, T, H, D),
    differentiable. ``dropout_rate > 0`` drops attention probabilities
    with bits from ``dropout_seed`` (an int, split into the kernels' two
    seed words); ``block_q``/``block_k`` set the logical dropout tiles.
    A head shard passes its first head ``head_offset`` and the unsharded
    head count ``num_heads``, and draws those heads' bits."""
    if not causal:
        raise NotImplementedError("flash_attention is causal-only")
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    B, T, H, D = q.shape
    seeds = seed_words(dropout_seed) if rate > 0.0 else (0, 0)

    def to3(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()

    heads = (None if num_heads is None or (head_offset == 0
                                           and num_heads == H)
             else (int(head_offset), H, int(num_heads)))
    args = (seeds, 1.0 / (D ** 0.5), int(block_q), int(block_k), rate,
            heads)
    if _device_of("flash_attention", q):
        o3 = _Flash.apply(to3(q), to3(k), to3(v), *args)
    else:
        # a CPU tensor: the plain forward, differentiated by autograd
        o3 = flash_fwd_plain(to3(q), to3(k), to3(v), *args)[0]
    return o3.reshape(B, H, T, D).permute(0, 2, 1, 3)
