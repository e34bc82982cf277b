"""Language-neutral binary serialization of Program IR ("PTPB" format).

Counterpart of ``paddle_tpu/core/program_bin.py``, the same format byte
for byte: a program built alike through either package (same names, same
attrs) serializes to the same bytes, and a ``__model__`` written by one
loads into the other. The C++ twin is ``native/src/program.h``, which
``native.py`` and ``Predictor.run_native_reference`` parse it with.

Layout (all ints little-endian):
  file   := magic "PTPB" | u32 version | u64 random_seed | u32 nblocks
            | block*
  block  := i32 idx | i32 parent_idx | i32 forward_block_idx
            | u32 nvars | var* | u32 nops | op*
  var    := str name | str type | u8 has_dtype [str dtype]
            | u8 has_shape [u32 ndim, i64*ndim] | u32 lod_level
            | u8 flags (1=persistable, 2=stop_gradient, 4=is_data,
                        8=is_parameter, 16=trainable)
  op     := str type | u32 nslots_in  | (str slot, u32 n, str*n)*
            | u32 nslots_out | same | u32 nattrs | (str name, attr)*
  attr   := u8 tag | value      tags: 0 i64, 1 f64, 2 str, 3 bool,
            4 i64-list, 5 f64-list, 6 str-list, 7 none
  str    := u32 len | utf-8 bytes
"""

import struct

from paddle_tpu_torch.framework import (
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
)

MAGIC = b"PTPB"
VERSION = 1

_ATTR_INT, _ATTR_FLOAT, _ATTR_STR, _ATTR_BOOL = 0, 1, 2, 3
_ATTR_INTS, _ATTR_FLOATS, _ATTR_STRS, _ATTR_NONE = 4, 5, 6, 7


class _Writer(object):
    def __init__(self):
        self.parts = []

    def u8(self, v):
        self.parts.append(struct.pack("<B", v))

    def u32(self, v):
        self.parts.append(struct.pack("<I", v))

    def i32(self, v):
        self.parts.append(struct.pack("<i", v))

    def i64(self, v):
        self.parts.append(struct.pack("<q", v))

    def u64(self, v):
        self.parts.append(struct.pack("<Q", v))

    def f64(self, v):
        self.parts.append(struct.pack("<d", v))

    def s(self, v):
        b = v.encode("utf-8")
        self.u32(len(b))
        self.parts.append(b)

    def bytes(self):
        return b"".join(self.parts)


class _Reader(object):
    def __init__(self, data):
        self.data = data
        self.off = 0

    def _unpack(self, fmt, size):
        v = struct.unpack_from(fmt, self.data, self.off)[0]
        self.off += size
        return v

    def u8(self):
        return self._unpack("<B", 1)

    def u32(self):
        return self._unpack("<I", 4)

    def i32(self):
        return self._unpack("<i", 4)

    def i64(self):
        return self._unpack("<q", 8)

    def u64(self):
        return self._unpack("<Q", 8)

    def f64(self):
        return self._unpack("<d", 8)

    def s(self):
        n = self.u32()
        v = self.data[self.off:self.off + n].decode("utf-8")
        self.off += n
        return v


def _write_attr(w, val):
    if val is None:
        w.u8(_ATTR_NONE)
    elif isinstance(val, bool):
        w.u8(_ATTR_BOOL)
        w.u8(1 if val else 0)
    elif isinstance(val, int):
        w.u8(_ATTR_INT)
        w.i64(val)
    elif isinstance(val, float):
        w.u8(_ATTR_FLOAT)
        w.f64(val)
    elif isinstance(val, str):
        w.u8(_ATTR_STR)
        w.s(val)
    elif isinstance(val, (list, tuple)):
        items = list(val)
        if items and all(isinstance(i, str) for i in items):
            w.u8(_ATTR_STRS)
            w.u32(len(items))
            for i in items:
                w.s(i)
        elif any(isinstance(i, float) for i in items):
            w.u8(_ATTR_FLOATS)
            w.u32(len(items))
            for i in items:
                w.f64(float(i))
        else:
            w.u8(_ATTR_INTS)
            w.u32(len(items))
            for i in items:
                w.i64(int(i))
    else:
        raise TypeError(
            "attr value %r (%s) is not serializable" % (val, type(val))
        )


def _read_attr(r):
    tag = r.u8()
    if tag == _ATTR_NONE:
        return None
    if tag == _ATTR_BOOL:
        return bool(r.u8())
    if tag == _ATTR_INT:
        return r.i64()
    if tag == _ATTR_FLOAT:
        return r.f64()
    if tag == _ATTR_STR:
        return r.s()
    if tag == _ATTR_INTS:
        return [r.i64() for _ in range(r.u32())]
    if tag == _ATTR_FLOATS:
        return [r.f64() for _ in range(r.u32())]
    if tag == _ATTR_STRS:
        return [r.s() for _ in range(r.u32())]
    raise ValueError("bad attr tag %d" % tag)


def serialize_program(program):
    """Program -> bytes (the PTPB flat binary)."""
    w = _Writer()
    w.parts.append(MAGIC)
    w.u32(VERSION)
    w.u64(int(program.random_seed))
    w.u32(len(program.blocks))
    for block in program.blocks:
        w.i32(block.idx)
        w.i32(block.parent_idx)
        w.i32(getattr(block, "forward_block_idx", -1))
        w.u32(len(block.vars))
        for name in sorted(block.vars):
            v = block.vars[name]
            w.s(v.name)
            w.s(v.type)
            dtype = v.recorded_dtype
            w.u8(1 if dtype is not None else 0)
            if dtype is not None:
                w.s(str(dtype))
            shape = v.shape
            w.u8(1 if shape is not None else 0)
            if shape is not None:
                w.u32(len(shape))
                for d in shape:
                    w.i64(int(d))
            w.u32(int(v.lod_level or 0))
            flags = (
                (1 if v.persistable else 0)
                | (2 if v.stop_gradient else 0)
                | (4 if getattr(v, "is_data", False) else 0)
                | (8 if isinstance(v, Parameter) else 0)
                | (16 if getattr(v, "trainable", False) else 0)
            )
            w.u8(flags)
        w.u32(len(block.ops))
        for op in block.ops:
            w.s(op.type)
            for io in (op.inputs, op.outputs):
                w.u32(len(io))
                for slot in sorted(io):
                    w.s(slot)
                    names = io[slot]
                    w.u32(len(names))
                    for n in names:
                        w.s(n if n is not None else "")
            attrs = {k: v for k, v in op.attrs.items()}
            w.u32(len(attrs))
            for name in sorted(attrs):
                w.s(name)
                _write_attr(w, attrs[name])
    return w.bytes()


def deserialize_program(data):
    """bytes -> Program (inverse of serialize_program)."""
    r = _Reader(data)
    if r.data[:4] != MAGIC:
        raise ValueError("not a PTPB program (bad magic)")
    r.off = 4
    version = r.u32()
    if version != VERSION:
        raise ValueError("unsupported PTPB version %d" % version)
    program = Program()
    program.random_seed = r.u64()
    nblocks = r.u32()
    program.blocks = []
    for _ in range(nblocks):
        idx = r.i32()
        parent = r.i32()
        fwd_idx = r.i32()
        block = Block(program, idx, parent)
        block.forward_block_idx = fwd_idx
        program.blocks.append(block)
        for _ in range(r.u32()):
            name = r.s()
            vtype = r.s()
            dtype = r.s() if r.u8() else None
            shape = None
            if r.u8():
                shape = tuple(r.i64() for _ in range(r.u32()))
            lod_level = r.u32()
            flags = r.u8()
            if flags & 8:
                v = Parameter(
                    block, name, shape, dtype,
                    trainable=bool(flags & 16),
                )
            else:
                v = Variable(
                    block, name=name, shape=shape, dtype=dtype, type=vtype,
                    lod_level=lod_level,
                )
            v.persistable = bool(flags & 1)
            v.stop_gradient = bool(flags & 2)
            v.is_data = bool(flags & 4)
            block.vars[name] = v
        nops = r.u32()
        for _ in range(nops):
            op_type = r.s()
            ios = []
            for _io in range(2):
                slots = {}
                for _s in range(r.u32()):
                    slot = r.s()
                    slots[slot] = [r.s() for _ in range(r.u32())]
                ios.append(slots)
            attrs = {}
            for _a in range(r.u32()):
                aname = r.s()
                attrs[aname] = _read_attr(r)
            op = Operator.__new__(Operator)
            op.block = block
            op.type = op_type
            op.inputs = ios[0]
            op.outputs = ios[1]
            op.attrs = attrs
            block.ops.append(op)
    program.current_block_idx = 0
    return program
