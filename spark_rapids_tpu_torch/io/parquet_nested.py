"""Nested Parquet columns: the schema tree, level assembly and shredding.

A nested column (LIST, MAP, STRUCT, or a legacy repeated field) spans
several leaf column chunks. Each leaf chunk decodes in the host library
(csrc/host/parquet_decode.cpp) into one value slot, one definition level
and one repetition level per level entry; ``assemble`` turns them into
``columnar/nested.py``'s flat host lanes, ``HostList`` (offsets and the
child's lane) and ``HostStruct`` (one lane per field), with numpy over
whole arrays, never a Python object per row. A MAP is ``list<struct<key,
value>>``. The writer's side, ``shred``, is the inverse: a host lane
into each leaf's levels and values.

The schema follows LogicalTypes.md:

- the standard three-level LIST (``<list> group (LIST) { repeated group
  list { <element> } }``) and MAP (``group (MAP) { repeated group
  key_value { required key; <value> } }``, or MAP_KEY_VALUE);
- the backward-compatibility rules for two-level lists: a repeated
  primitive is the element; a repeated group of several fields, or one
  named ``array`` or ``<name>_tuple``, is the element itself;
- a repeated field outside a LIST or MAP annotation is a required list
  of required elements.

Levels: each OPTIONAL or REPEATED field adds one definition level, each
REPEATED one repetition level. A node's slots in a leaf's level arrays
are the entries whose repetition level is at most its anchor's (the
nearest enclosing list element's, 0 at the top) and whose definition
level reaches the anchor's; a node is non-null at a slot where the
definition level reaches its own ``def_valid``. A list's elements are
the entries at or below its repetition level whose definition level
reaches ``def_elem``, so a null list (below ``def_valid``), an empty one
(at ``def_valid``, below ``def_elem``) and a null element stay three
different things, as do a null struct and one whose fields are all
null.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..columnar import dtypes as dt
from ..columnar.nested import HostList, HostStruct
from ..columnar.vector import HostStrings
from . import thrift as T


class Node:
    """One node of a column's schema tree. ``kind`` is leaf, struct,
    list or map; ``def_valid`` the definition level at which it is
    non-null. A list or map has ``def_elem`` / ``rep`` (the levels of
    its repeated field) and ``child`` (a map's is struct<key, value>);
    a struct has ``fields`` [(name, Node)]; a leaf has ``chunk`` (its
    column chunk's index), ``element``, ``max_def`` and ``max_rep``."""

    __slots__ = ("kind", "name", "dtype", "why", "def_valid", "def_elem",
                 "rep", "child", "fields", "chunk", "element", "max_def",
                 "max_rep")

    def __init__(self, kind: str, name: str, def_valid: int):
        self.kind, self.name, self.def_valid = kind, name, def_valid
        self.dtype: Optional[dt.DType] = None
        self.why: Optional[str] = None
        self.def_elem = self.rep = self.chunk = self.max_def = \
            self.max_rep = 0
        self.child: Optional[Node] = None
        self.fields: List[Tuple[str, Node]] = []
        self.element: Optional[T.SchemaElement] = None

    def leaves(self) -> List["Node"]:
        if self.kind == "leaf":
            return [self]
        if self.kind == "struct":
            return [x for _, f in self.fields for x in f.leaves()]
        return self.child.leaves()


def _annotation(el: T.SchemaElement) -> Optional[str]:
    logical = el.logicalType.name if el.logicalType is not None else None
    if logical == "LIST" or el.converted_type == T.LIST:
        return "LIST"
    if logical == "MAP" or el.converted_type in (T.MAP, T.MAP_KEY_VALUE):
        return "MAP"
    return None


def _list(name: str, d: int, r: int, child: Node, kind="list") -> Node:
    n = Node(kind, name, d)
    n.def_elem, n.rep, n.child = d + 1, r + 1, child
    n.why = child.why
    if child.dtype is not None:
        n.dtype = dt.MapType(*[f.dtype for _, f in child.fields]) \
            if kind == "map" else dt.ArrayType(child.dtype)
    return n


def field_node(schema, i: int, d: int, r: int, leaves: List[int],
               dtype_of) -> Tuple[Node, int]:
    """The node of ``schema[i]`` under a parent at levels (d, r), and the
    index after its subtree; ``leaves`` counts the leaf chunks, and
    ``dtype_of(el)`` gives a leaf's (dtype, why not)."""
    el = schema[i]
    if el.repetition_type == T.REPEATED:
        # outside a LIST / MAP: a required list of required elements
        child, end = value_node(schema, i, d + 1, r + 1, leaves, dtype_of)
        return _list(el.name, d, r, child), end
    if el.repetition_type == T.OPTIONAL:
        d += 1
    return value_node(schema, i, d, r, leaves, dtype_of)


def value_node(schema, i: int, d: int, r: int, leaves: List[int],
               dtype_of) -> Tuple[Node, int]:
    """The node of ``schema[i]`` whose own repetition is counted in
    (d, r) already."""
    el = schema[i]
    end = T.subtree_end(schema, i)
    if not el.num_children:
        n = Node("leaf", el.name, d)
        n.chunk, n.element, n.max_def, n.max_rep = leaves[0], el, d, r
        leaves[0] += 1
        n.dtype, n.why = dtype_of(el)
        return n, end
    kind = _annotation(el)
    if kind is not None:
        rg = schema[i + 1]
        if el.num_children != 1 or rg.repetition_type != T.REPEATED:
            leaves[0] += sum(1 for e in schema[i:end] if not e.num_children)
            n = Node("leaf", el.name, d)
            n.why = f"a {kind} group without one repeated field"
            return n, end
        de, re_ = d + 1, r + 1
        if kind == "MAP":
            if (rg.num_children or 0) != 2:
                leaves[0] += sum(1 for e in schema[i:end]
                                 if not e.num_children)
                n = Node("leaf", el.name, d)
                n.why = "a MAP whose key_value group is not (key, value)"
                return n, end
            key, j = field_node(schema, i + 2, de, re_, leaves, dtype_of)
            value, _ = field_node(schema, j, de, re_, leaves, dtype_of)
            entry = _struct(rg.name, de, [("key", key), ("value", value)])
            return _list(el.name, d, r, entry, "map"), end
        if not rg.num_children or rg.num_children > 1 or \
                rg.name in ("array", f"{el.name}_tuple"):
            child, _ = value_node(schema, i + 1, de, re_, leaves, dtype_of)
        else:
            child, _ = field_node(schema, i + 2, de, re_, leaves, dtype_of)
        return _list(el.name, d, r, child), end
    fields, j = [], i + 1
    for _ in range(el.num_children):
        f, j = field_node(schema, j, d, r, leaves, dtype_of)
        fields.append((f.name, f))
    return _struct(el.name, d, fields), end


def _struct(name: str, d: int, fields) -> Node:
    n = Node("struct", name, d)
    n.fields = fields
    whys = [f.why for _, f in fields if f.why]
    n.why = whys[0] if whys else None
    if not whys and all(f.dtype is not None for _, f in fields):
        n.dtype = dt.StructType([(k, f.dtype) for k, f in fields])
    return n


# ---------------------------------------------------------------------------
# read: levels -> host lanes
# ---------------------------------------------------------------------------

def assemble(node: Node, decoded, anchor=(0, 0)):
    """(host lane, mask) of ``node`` over its slots. ``decoded`` maps a
    leaf's chunk index to (lane, def levels, rep levels), one entry per
    level entry."""
    first = node.leaves()[0]
    _, D, R = decoded[first.chunk]
    rep_a, def_a = anchor
    idx = np.flatnonzero((R <= rep_a) & (D >= def_a))
    valid = D[idx] >= node.def_valid
    if node.kind == "leaf":
        return take_lane(decoded[node.chunk][0], idx), valid
    if node.kind == "struct":
        return HostStruct([assemble(f, decoded, anchor)
                           for _, f in node.fields]), valid
    elems = np.flatnonzero((R <= node.rep) & (D >= node.def_elem))
    offsets = np.empty(len(idx) + 1, np.int64)
    offsets[:-1] = np.searchsorted(elems, idx)
    offsets[-1] = len(elems)
    lane, mask = assemble(node.child, decoded, (node.rep, node.def_elem))
    return HostList(offsets, lane, mask), valid


# ---------------------------------------------------------------------------
# write: host lanes -> levels
# ---------------------------------------------------------------------------

def take_lane(lane, idx: np.ndarray):
    """Rows ``idx`` of any host lane."""
    if isinstance(lane, (HostStrings, HostList, HostStruct)):
        return lane.take(idx)
    return np.asarray(lane)[idx]


def shred(node: Node, lane, mask) -> dict:
    """The inverse of ``assemble``: {leaf chunk: (present values, def
    levels, rep levels)} for the rows of a flat host lane (``flat_lane``)
    of a column whose tree is ``node``; the values are the lane of the
    entries at the leaf's maximum definition level, in order."""
    mask = np.asarray(mask, bool)
    n = len(mask)
    got = _shred(node, lane, mask, np.zeros(n, np.uint8),
                 np.zeros(n, np.uint8))
    return {chunk: (vals, D, R) for chunk, (vals, D, R, _) in got.items()}


def _shred(node, lane, mask, d_above, rep_first) -> dict:
    """{chunk: (values, D, R, entries per slot)} over this node's slots:
    ``d_above`` the definition level the ancestors of each slot reached,
    ``rep_first`` the repetition level of its first entry."""
    here = np.where(mask, node.def_valid, d_above).astype(np.uint8)
    if node.kind == "leaf":
        return {node.chunk: (take_lane(lane, np.flatnonzero(mask)), here,
                             rep_first.astype(np.uint8),
                             np.ones(len(mask), np.int64))}
    if node.kind == "struct":
        out = {}
        for (_, f), (flane, fmask) in zip(node.fields, lane.fields):
            out.update(_shred(f, flane, np.asarray(fmask, bool) & mask,
                              here, rep_first))
        return out
    offsets = np.asarray(lane.offsets, np.int64)
    lens = np.where(mask, offsets[1:] - offsets[:-1], 0)
    owner = np.repeat(np.arange(len(lens)), lens)
    within = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                    lens)
    src = np.repeat(offsets[:-1], lens) + within
    erep = np.where(within == 0, rep_first[owner], node.rep).astype(np.uint8)
    child = _shred(node.child, take_lane(lane.values, src),
                   np.asarray(lane.mask, bool)[src],
                   np.full(len(src), node.def_elem, np.uint8), erep)
    lone = lens == 0
    out = {}
    for chunk, (vals, D, R, cnt) in child.items():
        # a row's entries: its elements' entries, or one entry of its
        # own where it has no element (a null or an empty list)
        row_cnt = np.ones(len(lens), np.int64)
        np.add.at(row_cnt, owner, cnt)
        row_cnt[~lone] -= 1
        start = np.cumsum(row_cnt) - row_cnt
        total = int(row_cnt.sum())
        nD = np.empty(total, np.uint8)
        nR = np.empty(total, np.uint8)
        at_lone = start[lone]
        nD[at_lone] = here[lone]
        nR[at_lone] = rep_first[lone]
        rest = np.ones(total, bool)
        rest[at_lone] = False
        nD[rest] = D
        nR[rest] = R
        out[chunk] = (vals, nD, nR, row_cnt)
    return out


def flat_lane(values, mask, t: dt.DType):
    """A nested host lane as flat lanes all the way down (``HostList``
    / ``HostStruct`` over leaf lanes); an object array of Python values
    (lists, dicts, tuples) is converted once."""
    from ..columnar.nested import _leaf_lane
    mask = np.asarray(mask, bool)
    if isinstance(values, HostList):
        return HostList(values.offsets, flat_lane(
            values.values, values.mask, t.element_type), values.mask)
    if isinstance(values, HostStruct):
        return HostStruct([(flat_lane(v, m, ft), m) for (v, m), ft in
                           zip(values.fields, t.field_types())])
    if not t.is_nested:
        if t == dt.STRING and not isinstance(values, HostStrings):
            return HostStrings.from_objects(
                [v if ok else None for v, ok in zip(values, mask)])
        return values
    rows = [v if ok else None for v, ok in zip(values, mask)]
    if isinstance(t, (dt.ArrayType, dt.MapType)):
        flat, lens = [], np.zeros(len(rows), np.int64)
        for k, v in enumerate(rows):
            if v is None:
                continue
            if isinstance(t, dt.MapType):
                pairs = v.items() if isinstance(v, dict) else v
                v = [{"key": a, "value": b} for a, b in pairs]
            flat.extend(v)
            lens[k] = len(v)
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        et = t.element_type
        cmask = np.array([v is not None for v in flat], bool)
        child = _objects(flat) if et.is_nested else flat
        return HostList(offsets, flat_lane(child, cmask, et)
                        if et.is_nested else _leaf_lane(flat, et)[0], cmask)
    fields = []
    for i, (name, ft) in enumerate(t.fields):
        fv = [None if v is None else
              (v.get(name) if isinstance(v, dict) else v[i]) for v in rows]
        fm = np.array([v is not None for v in fv], bool)
        fields.append((flat_lane(_objects(fv), fm, ft) if ft.is_nested
                       else _leaf_lane(fv, ft)[0], fm))
    return HostStruct(fields)


def _objects(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


def writer_elements(name: str, t: dt.DType, path=()):
    """The schema elements the writer declares for a column (Arrow's and
    Spark's layout: every field OPTIONAL, a LIST's three levels, a MAP's
    ``key_value`` group with a REQUIRED key) and each leaf's
    path_in_schema."""
    from .parquet_schema import schema_element
    path = path + (name,)
    if not t.is_nested:
        return [schema_element(name, t)], [list(path)]
    if isinstance(t, dt.MapType):
        kel, kpaths = writer_elements("key", t.key_type,
                                      path + ("key_value",))
        kel[0].repetition_type = T.REQUIRED
        vel, vpaths = writer_elements("value", t.value_type,
                                      path + ("key_value",))
        return ([T.SchemaElement(name=name, repetition_type=T.OPTIONAL,
                                 num_children=1, converted_type=T.MAP,
                                 logicalType=T.LogicalType(MAP=T.Empty())),
                 T.SchemaElement(name="key_value", num_children=2,
                                 repetition_type=T.REPEATED)]
                + kel + vel, kpaths + vpaths)
    if isinstance(t, dt.ArrayType):
        el, paths = writer_elements("element", t.element_type,
                                    path + ("list",))
        return ([T.SchemaElement(name=name, repetition_type=T.OPTIONAL,
                                 num_children=1, converted_type=T.LIST,
                                 logicalType=T.LogicalType(LIST=T.Empty())),
                 T.SchemaElement(name="list", num_children=1,
                                 repetition_type=T.REPEATED)] + el, paths)
    els = [T.SchemaElement(name=name, repetition_type=T.OPTIONAL,
                           num_children=len(t.fields))]
    paths = []
    for fname, ft in t.fields:
        e, p = writer_elements(fname, ft, path)
        els += e
        paths += p
    return els, paths
