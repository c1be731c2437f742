"""Checkpoints of the JAX package's msgpack family, without flax.

Counterpart of the JAX package's ``utils/checkpoint.py``: a checkpoint is
the msgpack encoding (``flax.serialization.msgpack_serialize``) of the
dict ``{current_epoch, model_state_dict, optimizer_state_dict,
scheduler_state_dict[, teacher_state_dict]}``, where
``model_state_dict`` is the flax variables tree (``{'params',
'batch_stats'}``, numpy leaves), ``optimizer_state_dict`` is
``{'__flat_leaves__': [...]}`` (the optax state's leaves in order) and
``scheduler_state_dict`` holds the epoch counter.  Files written here
load in the JAX package and the other way round; the port carries the
weights across with ``utils/torch_import.py`` and the optimizer state
with ``train/common.py``.

The codec below is the standard library's: exactly the subset of
msgpack that flax writes (maps with string keys, strings, ints, floats,
bool, nil, lists, bin, and the ext types 1, an ndarray as ``(shape,
dtype name, bytes)``, and 3, a numpy scalar in the same form).  It
writes what flax writes byte for byte: dict keys in sorted order, the
smallest encoding of each int and length, floats as float64.  Anything
else (tuples, other ext types, bfloat16 arrays, flax's chunked arrays
over 1 GiB) is refused with an error.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_ARRAY_BYTES = 2 ** 30       # flax chunks larger arrays; refused here
_CHUNKED = "__msgpack_chunked_array__"
_NUMERIC_KINDS = "biufc"


# ------------------------------------------------------------- encoding

def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < top:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit in 64 bits")
    else:
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)),
                               (0xd3, ">q", -(1 << 63))):
            if v >= low:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit in 64 bits")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int, codes) -> None:
    """A length header: ``fix | n`` below ``fix_max``, else the first of
    ``codes`` (8-, 16- or 32-bit length) that holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


_STR = (0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32)
_BIN = (0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32)
_ARR = (0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32)
_MAP = (0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32)
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _array_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.kind not in _NUMERIC_KINDS or arr.dtype.names:
        raise TypeError(f"cannot encode an array of dtype {arr.dtype}")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes: flax would chunk "
                         "it, which this codec does not write")
    inner = bytearray(b"\x93")            # [shape, dtype name, bytes]
    _pack_len(arr.ndim, inner, 0x90, 16, _ARR)
    for d in arr.shape:
        _pack_int(int(d), inner)
    _pack(arr.dtype.name, inner)
    _pack(arr.tobytes("C"), inner)
    return bytes(inner)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    if len(data) in _FIXEXT:
        out.append(_FIXEXT[len(data)])
    else:
        _pack_len(len(data), out, None, 0, ((0xc7, ">B", 1 << 8),
                                            (0xc8, ">H", 1 << 16),
                                            (0xc9, ">I", 1 << 32)))
    out += struct.pack(">b", code) + data


def _pack(obj: Any, out: bytearray) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if obj else 0xc2)
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xa0, 32, _STR)
        out += data
    elif t is bytes:
        _pack_len(len(obj), out, None, 0, _BIN)
        out += obj
    elif t is list:
        _pack_len(len(obj), out, 0x90, 16, _ARR)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, _MAP)
        for k in sorted(obj):
            if type(k) is not str:
                raise TypeError(f"map key {k!r}: only string keys")
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _array_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_bytes(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot encode {t.__name__} in a checkpoint")


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` gives for
    a tree of dicts (string keys), lists, numpy arrays and scalars,
    python scalars, strings, bytes and None."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


# ------------------------------------------------------------- decoding

class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.off = 0

    def take(self, n: int) -> memoryview:
        if self.off + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.off:self.off + n]
        self.off += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H",
        0xc6: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
        0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


def _unpack(r: _Reader, raw: bool = False) -> Any:
    b = r.unpack(">B")
    if b < 0x80:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b < 0x90 or b in (0xde, 0xdf):
        n = b & 0x0f if b < 0x90 else r.unpack(_LEN[b])
        out = {}
        for _ in range(n):
            k = _unpack(r, raw)
            if type(k) is not str:
                raise ValueError(f"map key {k!r}: only string keys")
            out[k] = _unpack(r, raw)
        if _CHUNKED in out:
            raise ValueError("chunked array (over 1 GiB): not supported")
        return out
    if 0x90 <= b < 0xa0 or b in (0xdc, 0xdd):
        n = b & 0x0f if b < 0xa0 else r.unpack(_LEN[b])
        return [_unpack(r, raw) for _ in range(n)]
    if 0xa0 <= b < 0xc0 or b in (0xd9, 0xda, 0xdb):
        n = b & 0x1f if b < 0xc0 else r.unpack(_LEN[b])
        data = bytes(r.take(n))
        return data if raw else data.decode("utf-8")
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in (0xc4, 0xc5, 0xc6):
        return bytes(r.take(r.unpack(_LEN[b])))
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _FIXEXT_LEN or b in (0xc7, 0xc8, 0xc9):
        n = _FIXEXT_LEN[b] if b in _FIXEXT_LEN else r.unpack(_LEN[b])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


def _ext(code: int, data: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not supported "
                         "(only 1, ndarray, and 3, numpy scalar)")
    r = _Reader(data)
    shape, name, buf = _unpack(r, raw=True)
    name = name.decode("ascii")
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported (numpy has no "
                         "bfloat16)")
    dtype = np.dtype(name)
    if dtype.kind not in _NUMERIC_KINDS:
        raise ValueError(f"array dtype {name} is not supported")
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    return arr[()] if code == EXT_NPSCALAR else arr


def msgpack_restore(data: bytes):
    """Inverse of :func:`msgpack_serialize`, as
    ``flax.serialization.msgpack_restore`` reads it (arrays come back
    writable)."""
    r = _Reader(data)
    out = _unpack(r)
    if r.off != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.off} trailing bytes after the "
                         "msgpack object")
    return out


# ------------------------------------------------------------ pytrees

def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order: dict values by
    sorted key, lists and tuples in order, None has none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` on every leaf; dicts come back with sorted keys (as
    ``jax.tree_util.tree_map`` gives them)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_numpy(tree):
    return tree_map(np.asarray, tree)


def save_checkpoint(path, current_epoch: int, model_state: Any,
                    optimizer_state: Any = None, scheduler_state: Any = None,
                    teacher_state: Any = None) -> Path:
    """Write ``<path>`` (a ``.ckpt`` file) or ``<path>/<epoch:04d>.ckpt``
    (a directory).  ``optimizer_state`` is stored as its flat leaf list."""
    path = Path(path)
    if path.suffix != ".ckpt":
        path.mkdir(parents=True, exist_ok=True)
        path = path / f"{current_epoch:04d}.ckpt"
    payload: Dict[str, Any] = {
        "current_epoch": int(current_epoch),
        "model_state_dict": _to_numpy(model_state),
        "optimizer_state_dict": {"__flat_leaves__": [
            np.asarray(x) for x in tree_leaves(optimizer_state)]},
        "scheduler_state_dict": _to_numpy(scheduler_state),
    }
    if teacher_state is not None:
        payload["teacher_state_dict"] = _to_numpy(teacher_state)
    path.write_bytes(msgpack_serialize(payload))
    return path


def load_checkpoint(path) -> Dict[str, Any]:
    """Read a checkpoint; a directory loads its highest-epoch ``*.ckpt``."""
    path = Path(path)
    if path.is_dir():
        ckpts = sorted(path.glob("*.ckpt"))
        if not ckpts:
            raise FileNotFoundError(f"No *.ckpt files in directory {path}")
        path = ckpts[-1]
    return msgpack_restore(path.read_bytes())


def restore_like(template: Any, state: Any) -> Any:
    """``state``'s leaves, in order, in the structure of ``template``,
    each reshaped to its template leaf's shape and cast to its dtype."""
    t_leaves, s_leaves = tree_leaves(template), tree_leaves(state)
    if len(t_leaves) != len(s_leaves):
        raise ValueError(
            f"Checkpoint has {len(s_leaves)} leaves but the live state "
            f"has {len(t_leaves)}; structures are incompatible.")
    it = iter(np.asarray(s).reshape(np.shape(t)).astype(np.asarray(t).dtype)
              for t, s in zip(t_leaves, s_leaves))
    return tree_map(lambda _: next(it), template)


def merge_state(current: Dict[str, Any], loaded: Dict[str, Any]
                ) -> Dict[str, Any]:
    """Tolerant merge: paths present in both trees take the loaded value
    (reshaped and cast to the current leaf), paths only in ``current``
    keep their value, paths only in ``loaded`` are ignored."""

    def _merge(cur, new):
        if isinstance(cur, dict) and isinstance(new, dict):
            return {k: (_merge(v, new[k]) if k in new else v)
                    for k, v in cur.items()}
        return np.asarray(new).reshape(np.shape(cur)).astype(
            np.asarray(cur).dtype)

    return _merge(current, loaded)
