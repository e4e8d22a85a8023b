"""The fused multi-tensor optimizer update: the CUDA kernels
``csrc/fused_optimizer.cu`` (``fused_update``, ``grad_sq_norm``), their
plain PyTorch versions, and ``UpdateTable``, a plan's tensors and
constants (counterpart of what ``paddle_tpu/optimizer/fused.py``
``FusedPlan._apply`` / ``fused_bucket_update`` leaves to XLA, and of the
norm in ``paddle_tpu/jit/bridge.py`` ``_clip_grads_functional``; there
is no Pallas kernel).

- ``fused_update(table, grads, lr, scales, bad)`` updates every
  parameter, master weight, moment and step counter of the table in
  place: the gradient clip, the coupled penalty, then SGD, Momentum or
  Adam(W).
- ``grad_sq_norm(table, grads)`` gives each gradient's sum of squares
  and the clip scale of each tensor (the global norm's, or the tensor's
  own norm's), which ``fused_update`` reads from device memory.

A CPU table takes the plain versions, which run the port's
per-parameter ops tensor by tensor (``optimizer/fused.py``
``fused_bucket_update``), so the CPU's fused step equals the
per-parameter step bit for bit. A CUDA table launches the kernels or
raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check, count_launch, load, stream_ptr

KIND_CODE = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2}
CLIP_NONE, CLIP_SCALE, CLIP_VALUE = 0, 1, 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CHUNK = 16384          # elements a CUDA block takes (kChunk)
MAX_TENSORS = 1024     # gradient addresses one launch takes (kMaxTensors)

# csrc/fused_optimizer.cu's Entry
_ENTRY = np.dtype({
    "names": ["p", "master", "m", "v", "step", "n", "wd", "lr_scale", "l2",
              "l1", "chunk0", "pdt", "gdt", "cdt"],
    "formats": ["<u8"] * 5 + ["<i8"] + ["<f4"] * 4 + ["<i4"] + ["u1"] * 3,
    "offsets": [0, 8, 16, 24, 32, 40, 48, 52, 56, 60, 64, 68, 69, 70],
    "itemsize": 72})

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fused_update": [_P, _I, _I, _P,            # table, n, chunks, grads
                     _I, _I, _I,                # kind, nesterov, clip
                     _F, _F, _F, _F, _F, _F,    # b1, 1-b1, b2, 1-b2, eps, mu
                     _F, _F,                    # clip lo, hi
                     _P, _P, _P, _P],           # lr, scales, bad, stream
    "grad_sq_partial_sums": [_P, _I, _I, _P, _I, _P, _P],
    "grad_sq_norm_finish": [_P, _P, _I, _I, _F, _P, _P, _P, _P],
}


class UpdateTable:
    """One plan's tensors and constants.

    ``kind``: "sgd", "momentum", "adam" or "adamw". ``states[i]`` is
    parameter i's optimizer state (``master_weight``, ``velocity``,
    ``moment1``, ``moment2``, ``step``), updated in place. ``coeffs``
    holds per-parameter lists ``l2``, ``l1``, ``wd`` and ``lr_scale``;
    ``hyper`` the optimizer's ``beta1``, ``beta2``, ``epsilon``,
    ``momentum`` and ``nesterov``; ``clip`` is None, ("global_norm", c),
    ("norm", c) or ("value", lo, hi). On a CUDA device the static part
    of the kernels' table (every address but the gradients') is packed
    into device memory here, once, in groups of at most ``MAX_TENSORS``.
    """

    def __init__(self, kind, params, states, coeffs, grad_dtypes, hyper,
                 clip=None):
        self.kind = kind
        self.params = list(params)
        self.states = list(states)
        self.coeffs = coeffs
        self.grad_dtypes = list(grad_dtypes)
        self.hyper = dict(hyper)
        self.clip = clip
        self.clip_mode = (CLIP_NONE if clip is None else
                          CLIP_VALUE if clip[0] == "value" else CLIP_SCALE)
        self.numels = [p.numel() for p in self.params]
        self.device = self.params[0].device
        if self.device.type == "cuda":
            self._pack()

    def _pack(self):
        for t in self.params + [g for st in self.states for g in st.values()]:
            if t.device != self.device or not t.is_contiguous():
                raise ValueError("fused_update: every parameter and state "
                                 "tensor must be contiguous, on one device")
        for p, gdt in zip(self.params, self.grad_dtypes):
            if p.dtype not in _DTYPE_CODE or gdt not in _DTYPE_CODE:
                raise TypeError(f"fused_update: unsupported dtypes {p.dtype}"
                                f" / {gdt} (kernel takes float32, bfloat16 "
                                "and float16)")
        n = len(self.params)
        ent = np.zeros(n, _ENTRY)
        chunks = [-(-k // CHUNK) for k in self.numels]
        self.chunk_starts = np.concatenate([[0], np.cumsum(chunks)]) \
            .astype(np.int64)

        def addr(st, key):
            t = st.get(key)
            return 0 if t is None else t.data_ptr()
        for i, (p, st) in enumerate(zip(self.params, self.states)):
            master = st.get("master_weight")
            cdt = torch.float32 if master is not None else p.dtype
            first = "velocity" if "velocity" in st else "moment1"
            ent[i] = (p.data_ptr(), addr(st, "master_weight"),
                      addr(st, first), addr(st, "moment2"), addr(st, "step"),
                      self.numels[i], self.coeffs["wd"][i],
                      self.coeffs["lr_scale"][i], self.coeffs["l2"][i],
                      self.coeffs["l1"][i], 0, _DTYPE_CODE[p.dtype],
                      _DTYPE_CODE[self.grad_dtypes[i]], _DTYPE_CODE[cdt])
        self.groups = []        # (first tensor, stop, entries, chunks)
        for lo in range(0, n, MAX_TENSORS):
            hi = min(lo + MAX_TENSORS, n)
            g = ent[lo:hi].copy()
            g["chunk0"] = self.chunk_starts[lo:hi] - self.chunk_starts[lo]
            self.groups.append((lo, hi, torch.from_numpy(
                g.view(np.uint8)).to(self.device),
                int(self.chunk_starts[hi] - self.chunk_starts[lo])))
        self.chunk_starts_dev = torch.from_numpy(
            self.chunk_starts.astype(np.int32)).to(self.device)
        self.gdts_dev = torch.tensor(
            [_DTYPE_CODE[d] for d in self.grad_dtypes], dtype=torch.uint8,
            device=self.device)
        h = self.hyper
        self._args = (
            KIND_CODE[self.kind], int(bool(h["nesterov"])), self.clip_mode,
            float(np.float32(h["beta1"])), float(np.float32(1 - h["beta1"])),
            float(np.float32(h["beta2"])), float(np.float32(1 - h["beta2"])),
            float(np.float32(h["epsilon"])), float(np.float32(h["momentum"])),
            *((float(self.clip[1]), float(self.clip[2]))
              if self.clip_mode == CLIP_VALUE else (0.0, 0.0)))

    def grad_ptrs(self, grads):
        """The gradients' addresses after checking each against the table
        (count, device, dtype, size, contiguity)."""
        if len(grads) != len(self.params):
            raise ValueError(f"fused_update: {len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        ptrs = []
        for g, dt, n in zip(grads, self.grad_dtypes, self.numels):
            if g.dtype != dt or g.numel() != n or not g.is_contiguous() \
                    or g.device != self.device:
                raise ValueError(
                    f"fused_update: gradient {tuple(g.shape)} {g.dtype} on "
                    f"{g.device} does not match the table ({n} elements of "
                    f"{dt}, contiguous, on {self.device})")
            ptrs.append(g.data_ptr())
        return (ctypes.c_uint64 * len(ptrs))(*ptrs)


def _scalar_ptr(t, dtype, device, what):
    if t is None:
        return None
    if t.dtype != dtype or t.numel() != 1 or t.device != device:
        raise ValueError(f"fused_update: {what} must be one {dtype} on "
                         f"{device}")
    return t.data_ptr()


# ---------------------------------------------------------- grad_sq_norm --

def grad_sq_norm_plain(table, grads):
    """(sq, scales), f32 [n] each: the sums of squares the clip takes and
    each tensor's clip scale, in ``nn/clip.py``'s ops. Global norm:
    ``sum(square(g.float()))`` per tensor, summed in order, and
    ``where(gn > c, c / max(gn, 1e-12), 1)`` for all. A tensor's own norm
    (``ClipGradByNorm``): ``sum(g * g)`` in g's type and ``where(n > c,
    c / n, 1)``."""
    kind, c = table.clip[0], table.clip[1]
    if kind == "norm":
        sq = [torch.sum(g * g) for g in grads]
        nrm = [torch.sqrt(s) for s in sq]
        scales = [torch.where(n > c, c / n, 1.0) for n in nrm]
    else:
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        total = None
        for s in sq:
            total = s if total is None else total + s
        gn = torch.sqrt(total)
        scales = [torch.where(gn > c, c / torch.clamp(gn, min=1e-12), 1.0)]
        scales = scales * len(grads)
    return (torch.stack([s.float() for s in sq]),
            torch.stack([s.float() for s in scales]))


def grad_sq_norm_kernel(table, grads):
    """Launch the partial sums (one per group) and the fixed-order finish
    on the card: (sq, scales) as ``grad_sq_norm_plain`` gives them."""
    lib = load("fused_optimizer", _SIGNATURES)
    dev = table.device
    ptrs = table.grad_ptrs(grads)
    n = len(table.params)
    partial = torch.empty(int(table.chunk_starts[-1]), dtype=torch.float32,
                          device=dev)
    sq = torch.empty(n, dtype=torch.float32, device=dev)
    scales = torch.empty(n, dtype=torch.float32, device=dev)
    per_tensor = int(table.clip[0] == "norm")
    stream = stream_ptr(dev)
    for lo, hi, tab, n_chunks in table.groups:
        err = lib.grad_sq_partial_sums(
            tab.data_ptr(), hi - lo, n_chunks,
            ctypes.addressof(ptrs) + 8 * lo, per_tensor,
            partial.data_ptr() + 4 * int(table.chunk_starts[lo]), stream)
        check(err, "grad_sq_norm (partial sums)")
    err = lib.grad_sq_norm_finish(
        table.chunk_starts_dev.data_ptr(), table.gdts_dev.data_ptr(), n,
        per_tensor, float(table.clip[1]), partial.data_ptr(), sq.data_ptr(),
        scales.data_ptr(), stream)
    check(err, "grad_sq_norm (finish)")
    count_launch("grad_sq_norm")
    return sq, scales


def grad_sq_norm(table, grads):
    """Each gradient's sum of squares and each tensor's clip scale, for a
    table whose clip is a norm. A CPU table takes the plain version; a
    CUDA table launches the kernels or raises."""
    if table.clip_mode != CLIP_SCALE:
        raise ValueError("grad_sq_norm: the table's clip is not a norm")
    if table.device.type == "cpu":
        return grad_sq_norm_plain(table, grads)
    return grad_sq_norm_kernel(table, grads)


# ---------------------------------------------------------- fused_update --

@torch.no_grad()
def fused_update_plain(table, grads, lr, scales=None, bad=None):
    """The per-parameter path's ops, tensor by tensor, on flat views: the
    clip as ``nn/clip.py`` applies it, then ``fused_bucket_update``; with
    ``bad`` every buffer keeps its value (a select); results written in
    place."""
    from ..optimizer.fused import _state_names, fused_bucket_update
    c = table.coeffs
    names = _state_names(table.kind)
    for i, (p, g, st) in enumerate(zip(table.params, grads, table.states)):
        if table.clip_mode == CLIP_SCALE:
            g = g * scales[i].to(g.dtype)
        elif table.clip_mode == CLIP_VALUE:
            g = torch.clamp(g, table.clip[1], table.clip[2])
        master = st.get("master_weight")
        cur = master if master is not None else p
        coeffs = {k: c[k][i] for k in ("l2", "l1", "wd", "lr_scale")}
        p2, s2 = fused_bucket_update(
            table.kind, cur.reshape(-1), g.to(cur.dtype).reshape(-1),
            {k: st[k].reshape(-1) if k != "step" else st[k] for k in names},
            lr, coeffs, table.hyper)
        p2 = p2.reshape(cur.shape)
        if master is not None:
            s2["master_weight"] = p2
            p2 = p2.to(p.dtype)
        if bad is not None:
            p2 = torch.where(bad, p, p2)
            s2 = {k: torch.where(bad, st[k], v.reshape(st[k].shape))
                  for k, v in s2.items()}
        p.copy_(p2)
        for k, v in s2.items():
            st[k].copy_(v.reshape(st[k].shape))


def fused_update_kernel(table, grads, lr, scales=None, bad=None):
    """Launch ``fused_update`` on the card, one launch per group of at most
    ``MAX_TENSORS`` tensors (one for every model the port runs)."""
    lib = load("fused_optimizer", _SIGNATURES)
    dev = table.device
    ptrs = table.grad_ptrs(grads)
    lr_p = _scalar_ptr(lr, torch.float32, dev, "lr")
    bad_p = _scalar_ptr(bad, torch.bool, dev, "bad")
    sc_p = None
    if table.clip_mode == CLIP_SCALE:
        if scales is None or scales.dtype != torch.float32 or \
                scales.shape != (len(table.params),) or scales.device != dev:
            raise ValueError("fused_update: a norm clip needs scales, f32 "
                             f"[{len(table.params)}] on {dev}")
        sc_p = scales.data_ptr()
    stream = stream_ptr(dev)
    for lo, hi, tab, n_chunks in table.groups:
        err = lib.fused_update(
            tab.data_ptr(), hi - lo, n_chunks, ctypes.addressof(ptrs) + 8 * lo,
            *table._args, lr_p, None if sc_p is None else sc_p + 4 * lo, bad_p,
            stream)
        check(err, "fused_update")
        count_launch("fused_update")


def fused_update(table, grads, lr, scales=None, bad=None):
    """One optimizer step of every tensor of ``table`` from ``grads`` at
    the f32 device scalar ``lr``: ``scales`` (from ``grad_sq_norm``) when
    the clip is a norm; with ``bad`` (a device bool scalar) set, nothing
    changes. A CPU table takes the plain version; a CUDA table launches
    the kernel or raises."""
    if table.device.type == "cpu":
        return fused_update_plain(table, grads, lr, scales, bad)
    return fused_update_kernel(table, grads, lr, scales, bad)
