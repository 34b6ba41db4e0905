"""Binary `.graph` checkpoint format — reader/writer compatible with the
reference's stype serialization; the port's own copy of
``aprilsam_tpu/io/stype.py`` (numpy and ``struct`` only).

Format (reference: stype_encode_object/stype_decode_object, common/stype.c:75-169;
encode_bytes.h big-endian codecs):

  object frame := u64 magic | string_u32 type-name | u32 payload-len
                  | payload | u64 magic
  (NULL object  := magic | "" | u32 0 | magic)

Graph payload (april_graph_encode, april_graph.c:250-282):
  (u8 1, node-frame)* (u8 2, factor-frame)* u8 0  attr-frame

Node "april_graph_node_xyt" payload (april_graph_xyt.c:358-383):
  3*f64 state | u8 has_init [3*f64] | u8 has_truth [3*f64] | attr-frame
Factor "april_graph_factor_xyt" payload (april_graph_xyt.c:216-240):
  u32 a | u32 b | 3*f64 z | u8 has_ztruth [3*f64] | 9*f64 W | attr-frame
Factor "april_graph_factor_xytpos" payload (april_graph_xytpos.c:133-160):
  u32 a | 3*f64 z | u8 has_ztruth [3*f64] | 9*f64 W | attr-frame
Attr "april_graph_attr_t" payload (april_graph.c:178-197):
  (u8 1 | string_u32 key | value-frame)* u8 0
Basic stypes (stype_basic_types.c): "uint64" = u64; "string" = string_u32.

The reference's magic numbers are a process-global counter; decode only checks
that the opening and closing magics of a frame match, so the writer here uses
its own counter.  Unknown value types are preserved as ("__opaque__", name,
payload-bytes) and re-emitted verbatim on save (same skip-unknown resilience
as stype.c:109-169).
"""

from __future__ import annotations

import struct
from typing import Any, Optional, Tuple

import numpy as np

from ..graph import Attributes, FactorGraph, FACTOR_XYT, FACTOR_XYTPOS

_MAGIC0 = 0x7B287F8A1579A0ED  # stype.c:79


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from(">I", self.data, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from(">Q", self.data, self.pos)
        self.pos += 8
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from(">d", self.data, self.pos)
        self.pos += 8
        return v

    def f64s(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.data, dtype=">f8", count=n, offset=self.pos)
        self.pos += 8 * n
        return v.astype(np.float64)

    def string(self) -> str:
        n = self.u32()
        s = self.data[self.pos : self.pos + n].decode("utf-8", errors="replace")
        self.pos += n
        return s


class _Writer:
    def __init__(self):
        self.parts = []
        self.magic = _MAGIC0

    def u8(self, v: int):
        self.parts.append(struct.pack(">B", v))

    def u32(self, v: int):
        self.parts.append(struct.pack(">I", v))

    def u64(self, v: int):
        self.parts.append(struct.pack(">Q", v))

    def f64(self, v: float):
        self.parts.append(struct.pack(">d", v))

    def f64s(self, arr):
        self.parts.append(np.asarray(arr, dtype=">f8").tobytes())

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u32(len(b))
        self.parts.append(b)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


# --------------------------------------------------------------- decoding

def _decode_object(r: _Reader) -> Tuple[Optional[str], Any]:
    """Decode one stype frame; returns (type-name or None, value)."""
    magic = r.u64()
    name = r.string()
    length = r.u32()
    start = r.pos
    if name == "":
        value = None
    elif name == "uint64":
        value = r.u64()
    elif name == "string":
        value = r.string()
    elif name == "april_graph_attr_t":
        value = _decode_attr(r)
    else:
        # unknown type: preserve payload verbatim (skip-unknown recovery,
        # stype.c:126-152)
        value = ("__opaque__", name, r.data[start : start + length])
        r.pos = start + length
    if r.pos != start + length and name not in ("",):
        # be tolerant like the reference: trust the declared length
        r.pos = start + length
    magic2 = r.u64()
    if magic != magic2:
        raise ValueError(
            f"stype magic mismatch decoding {name!r}: {magic:#x} != {magic2:#x}"
        )
    return (name if name else None), value


def _decode_attr(r: _Reader) -> Attributes:
    attrs = Attributes()
    while r.u8():
        key = r.string()
        name, value = _decode_object(r)
        if isinstance(value, tuple) and value and value[0] == "__opaque__":
            attrs.put(value[1], key, value)
        else:
            attrs.put(name or "", key, value)
    return attrs


def _decode_node(r: _Reader):
    state = r.f64s(3)
    init = r.f64s(3) if r.u8() else None
    truth = r.f64s(3) if r.u8() else None
    _, attr = _decode_object(r)
    return state, init, truth, attr


def _decode_factor_xyt(r: _Reader):
    a = r.u32()
    b = r.u32()
    z = r.f64s(3)
    ztruth = r.f64s(3) if r.u8() else None
    W = r.f64s(9).reshape(3, 3)
    _, attr = _decode_object(r)
    return a, b, z, ztruth, W, attr


def _decode_factor_xytpos(r: _Reader):
    a = r.u32()
    z = r.f64s(3)
    ztruth = r.f64s(3) if r.u8() else None
    W = r.f64s(9).reshape(3, 3)
    _, attr = _decode_object(r)
    return a, z, ztruth, W, attr


def load_graph_bytes(data: bytes) -> FactorGraph:
    r = _Reader(data)
    magic = r.u64()
    name = r.string()
    _length = r.u32()
    if name != "april_graph_t":
        raise ValueError(f"not an april_graph_t file (got {name!r})")
    g = FactorGraph()
    # Stored factor endpoints index nodes by their position in the FILE.
    # Unknown node types are skipped (stype.c:109-169 skip-unknown recovery),
    # so loaded indices can diverge from file indices; node_map remaps
    # endpoints and raises on a factor that references a skipped node instead
    # of silently misassociating it (the C reference renumbers densely and
    # would associate factors with the wrong nodes here).
    node_map: list = []
    while True:
        op = r.u8()
        if op == 0:
            break
        if op == 1:
            tname, _ = _peek_frame_name(r)
            if tname != "april_graph_node_xyt":
                _decode_object(r)  # skip unknown node type
                node_map.append(-1)
                continue
            magic_n = r.u64()
            r.string()
            r.u32()
            state, init, truth, attr = _decode_node(r)
            if r.u64() != magic_n:
                raise ValueError("node frame magic mismatch")
            idx = g.add_node(state, init=init, truth=truth)
            node_map.append(idx)
            if attr is not None and len(attr):
                g.node_attrs[idx] = attr
        elif op == 2:
            def remap(i: int) -> int:
                if i >= len(node_map) or node_map[i] < 0:
                    raise ValueError(
                        f"factor references node {i}, which was skipped "
                        "(unknown node type) or not yet decoded")
                return node_map[i]

            tname, _ = _peek_frame_name(r)
            if tname == "april_graph_factor_xyt":
                magic_f = r.u64()
                r.string()
                r.u32()
                a, b, z, ztruth, W, attr = _decode_factor_xyt(r)
                if r.u64() != magic_f:
                    raise ValueError("factor frame magic mismatch")
                fidx = g.add_factor_xyt(remap(a), remap(b), z, W,
                                        ztruth=ztruth)
            elif tname == "april_graph_factor_xytpos":
                magic_f = r.u64()
                r.string()
                r.u32()
                a, z, ztruth, W, attr = _decode_factor_xytpos(r)
                if r.u64() != magic_f:
                    raise ValueError("factor frame magic mismatch")
                fidx = g.add_factor_xytpos(remap(a), z, W, ztruth=ztruth)
            else:
                _decode_object(r)
                continue
            if attr is not None and len(attr):
                g.factor_attrs[fidx] = attr
        else:
            raise ValueError(f"bad opcode {op} (april_graph.c:316)")
    _, gattr = _decode_object(r)
    if gattr is not None:
        g.attr = gattr
    if r.u64() != magic:
        raise ValueError("graph frame magic mismatch")
    return g


def _peek_frame_name(r: _Reader) -> Tuple[str, int]:
    save = r.pos
    r.u64()
    name = r.string()
    r.pos = save
    return name, save


def load_graph_file(path: str) -> FactorGraph:
    with open(path, "rb") as f:
        return load_graph_bytes(f.read())


# --------------------------------------------------------------- encoding

def _encode_object(w: _Writer, name: Optional[str], payload_fn) -> None:
    magic = w.magic
    w.magic += 1
    w.u64(magic)
    if name is None:
        w.string("")
        w.u32(0)
    else:
        w.string(name)
        # measure payload by encoding into a sub-writer
        sub = _Writer()
        sub.magic = w.magic
        payload_fn(sub)
        w.magic = sub.magic
        body = sub.bytes()
        w.u32(len(body))
        w.parts.append(body)
    w.u64(magic)


def _encode_attr_payload(w: _Writer, attrs: Optional[Attributes]):
    if attrs is not None:
        for key, (stype_name, value) in attrs.data.items():
            w.u8(1)
            w.string(key)
            if isinstance(value, tuple) and value and value[0] == "__opaque__":
                _, opname, blob = value
                _encode_object(w, opname, lambda sw, b=blob: sw.parts.append(b))
            elif stype_name == "uint64":
                _encode_object(w, "uint64", lambda sw, v=value: sw.u64(int(v)))
            elif stype_name == "string":
                _encode_object(w, "string", lambda sw, v=value: sw.string(str(v)))
            else:
                raise ValueError(f"cannot encode attr type {stype_name!r}")
    w.u8(0)


def _encode_attr_object(w: _Writer, attrs: Optional[Attributes]):
    if attrs is None or len(attrs) == 0:
        # The reference writes a NULL frame when there is no attr object
        # (april_graph.c:280-281 passes attr=NULL).
        _encode_object(w, None, None)
    else:
        _encode_object(w, "april_graph_attr_t", lambda sw: _encode_attr_payload(sw, attrs))


def save_graph_bytes(g: FactorGraph) -> bytes:
    w = _Writer()

    def graph_payload(gw: _Writer):
        for i in range(g.nnodes):
            gw.u8(1)

            def node_payload(nw: _Writer, i=i):
                nw.f64s(g.state[i])
                if g.has_init[i]:
                    nw.u8(1)
                    nw.f64s(g.init[i])
                else:
                    nw.u8(0)
                if g.has_truth[i]:
                    nw.u8(1)
                    nw.f64s(g.truth[i])
                else:
                    nw.u8(0)
                _encode_attr_object(nw, g.node_attrs.get(i))

            _encode_object(gw, "april_graph_node_xyt", node_payload)
        for f in range(g.nfactors):
            gw.u8(2)
            if g.ftype[f] == FACTOR_XYT:

                def factor_payload(fw: _Writer, f=f):
                    fw.u32(int(g.fnodes[f, 0]))
                    fw.u32(int(g.fnodes[f, 1]))
                    fw.f64s(g.fz[f])
                    if g.has_ztruth[f]:
                        fw.u8(1)
                        fw.f64s(g.fztruth[f])
                    else:
                        fw.u8(0)
                    fw.f64s(g.fW[f].reshape(-1))
                    _encode_attr_object(fw, g.factor_attrs.get(f))

                _encode_object(gw, "april_graph_factor_xyt", factor_payload)
            elif g.ftype[f] == FACTOR_XYTPOS:

                def factor_payload(fw: _Writer, f=f):
                    fw.u32(int(g.fnodes[f, 0]))
                    fw.f64s(g.fz[f])
                    if g.has_ztruth[f]:
                        fw.u8(1)
                        fw.f64s(g.fztruth[f])
                    else:
                        fw.u8(0)
                    fw.f64s(g.fW[f].reshape(-1))
                    _encode_attr_object(fw, g.factor_attrs.get(f))

                _encode_object(gw, "april_graph_factor_xytpos", factor_payload)
            else:
                raise ValueError(f"unknown factor type {g.ftype[f]}")
        gw.u8(0)
        _encode_attr_object(gw, g.attr if len(g.attr) else None)

    _encode_object(w, "april_graph_t", graph_payload)
    return w.bytes()


def save_graph_file(g: FactorGraph, path: str) -> None:
    with open(path, "wb") as f:
        f.write(save_graph_bytes(g))
