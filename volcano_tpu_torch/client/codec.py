"""Wire codec for model objects: tagged JSON <-> dataclasses.

The networked ClusterStore (client.server / client.remote) carries the same
model objects the in-process store holds (volcano_tpu_torch.models
dataclasses, str-enums nested inside). The codec tags every dataclass node
with its class name and every enum with its enum class, so the receiving
side reconstructs real model instances — not dicts — and code like
``pg.status.phase == PodGroupPhase.RUNNING`` behaves identically on both
sides of the wire. JSON (not pickle) keeps the protocol inspectable and
closed over the model registry: a hostile peer can only instantiate
volcano_tpu_torch.models classes. Reference parity: the k8s API server
speaks typed JSON for the same objects (vcctl.go talks to it via
client-go).

The format is the JAX package's byte for byte: a tag names only the class,
so either package's peer decodes an object into its own class of that
name, and one WAL directory is recovered by either package.

Hot path: a burst moves tens of thousands of objects through
encode/decode (bulk ingest waves in, watch events out), so the codec is
built for throughput:

- per-class field plans are cached (``dataclasses.fields`` walks and
  per-call ``is_dataclass`` probes are paid once per class, not per
  object);
- encoding is SPARSE: a field whose value equals its static default (or
  an empty container from its default factory) is omitted — ``decode``
  has always rebuilt instances with ``cls(**present_fields)``, so
  missing fields regain their defaults on the other side, the wire/WAL
  stays format-compatible in both directions, and a mostly-default Pod
  costs less than half the bytes (and correspondingly less json time);
- primitives fast-path on exact type, so enums (str/int subclasses)
  still route to their tagged form first.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

from .. import models as _models

_T = "__t"   # dataclass tag
_E = "__e"   # enum tag
_B = "__b"   # bytes tag (Secret data values are bytes)
_D = "__d"   # escape tag: plain dict whose own keys collide with a tag
_RESERVED = frozenset((_T, _E, _B, _D))


def _registry() -> Dict[str, type]:
    reg: Dict[str, type] = {}
    for name in dir(_models):
        cls = getattr(_models, name)
        if isinstance(cls, type) and (
                dataclasses.is_dataclass(cls)
                or issubclass(cls, enum.Enum)):
            reg[cls.__name__] = cls
    return reg


_REGISTRY = _registry()

_MISSING = object()

#: per dataclass: ((field_name, skip_sentinel), ...) — skip_sentinel is
#: the value to omit from the wire (the field's static default, or the
#: empty container its default factory produces), or _MISSING when the
#: field must always be encoded
_ENC_PLANS: Dict[type, Tuple[Tuple[str, Any], ...]] = {}
#: per dataclass: frozenset of constructable field names
_KNOWN: Dict[type, frozenset] = {}


def _enc_plan(cls: type) -> Tuple[Tuple[str, Any], ...]:
    plan = _ENC_PLANS.get(cls)
    if plan is None:
        rows: List[Tuple[str, Any]] = []
        for f in dataclasses.fields(cls):
            sentinel: Any = _MISSING
            if f.default is not dataclasses.MISSING:
                sentinel = f.default
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                produced = f.default_factory()  # type: ignore[misc]
                # only stable, empty containers are skippable — a
                # factory like new_uid() produces a fresh value every
                # call, which an omitted field would silently replace
                if produced == {} or produced == [] or produced == ():
                    sentinel = produced
            rows.append((f.name, sentinel))
        plan = _ENC_PLANS[cls] = tuple(rows)
    return plan


def _known(cls: type) -> frozenset:
    known = _KNOWN.get(cls)
    if known is None:
        known = _KNOWN[cls] = frozenset(
            f.name for f in dataclasses.fields(cls))
    return known


def encode(obj: Any) -> Any:
    """Model object -> JSON-able structure (sparse: default-valued
    fields are omitted; decode restores them)."""
    t = obj.__class__
    # exact-type fast path: a str-enum's class is the enum, not str, so
    # enums fall through to their tagged form below
    if obj is None or t is str or t is int or t is float or t is bool:
        return obj
    if t is dict:
        out = {k: encode(v) for k, v in obj.items()}
        if _RESERVED & out.keys():
            # a user dict (annotation/label/template) whose own keys
            # collide with a tag must not be mistaken for a tagged node
            return {_D: out}
        return out
    if t is list or t is tuple:
        return [encode(v) for v in obj]
    plan = _ENC_PLANS.get(t)
    if plan is None:
        if isinstance(obj, enum.Enum):
            return {_E: t.__name__, "v": obj.value}
        if isinstance(obj, bytes):
            return {_B: base64.b64encode(obj).decode()}
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            plan = _enc_plan(t)
        elif isinstance(obj, (int, float, str, bool)):
            return obj  # bool/int/str subclasses that are not enums
        elif isinstance(obj, dict):
            out = {k: encode(v) for k, v in obj.items()}
            return {_D: out} if _RESERVED & out.keys() else out
        elif isinstance(obj, (list, tuple)):
            return [encode(v) for v in obj]
        else:
            raise TypeError(
                f"cannot encode {t.__name__} for the wire")
    fields: Dict[str, Any] = {}
    for name, sentinel in plan:
        v = getattr(obj, name)
        if sentinel is not _MISSING and (
                v is sentinel or v == sentinel):
            continue
        fields[name] = encode(v)
    return {_T: t.__name__, "f": fields}


def known_fields(cls: type) -> frozenset:
    """Constructable field names of a model dataclass (the set decode()
    filters against) — the delta patch path validates field names from
    the wire against this before any setattr."""
    return _known(cls)


def decode(data: Any) -> Any:
    """JSON structure -> model object (closed over the models registry).
    Fields absent from the wire regain their class defaults."""
    if isinstance(data, dict):
        tag = data.get(_T)
        if tag is not None:
            cls = _REGISTRY.get(tag)
            if cls is None or not dataclasses.is_dataclass(cls):
                raise ValueError(f"unknown model class {tag!r}")
            known = _known(cls)
            return cls(**{k: decode(v) for k, v in data["f"].items()
                          if k in known})
        etag = data.get(_E)
        if etag is not None:
            cls = _REGISTRY.get(etag)
            if cls is None or not issubclass(cls, enum.Enum):
                raise ValueError(f"unknown enum class {etag!r}")
            return cls(data["v"])
        btag = data.get(_B)
        if btag is not None:
            return base64.b64decode(btag)
        if _D in data:
            return {k: decode(v) for k, v in data[_D].items()}
        return {k: decode(v) for k, v in data.items()}
    if isinstance(data, list):
        return [decode(v) for v in data]
    return data


# -- delta watch dialect ------------------------------------------------------
#
# The ``delta: true`` watch mode (client/server.py negotiation) ships an
# UPDATE event as a field-sparse column patch instead of the full object
# form: one interned key id ("dk"), parallel columns of interned field
# ids and wire values ("df"/"dv"), and the fields that returned to their
# class defaults ("dx"). Hot immutable strings and enums (names, nodes,
# phases) are interned into an append-only per-stream table — the frame
# carries {"__i": id} references plus the table additions this event
# created ("tb": [start, [entries...]]) — so a storm of phase flips costs
# a few ints per event on the wire and ZERO full-object decodes on the
# client. Adds/deletes (and any update the dialect cannot express) stay
# object frames; the two forms interleave freely on one stream, which is
# what keeps journal-resume replay (always object form) compatible.

_I = "__i"   # interned-value reference (delta frames only)

#: interning-table hard cap per stream/shard: past this the server ships
#: raw values (no fallback needed server-side); a CLIENT asked to grow
#: beyond its own cap falls back typed (``vocab_overflow``)
DELTA_VOCAB_MAX = 65536


class Interner:
    """Append-only value table for the delta dialect. Entries are wire
    (encoded) values — plain strings, or tagged enum forms — identified
    by position; callers snapshot the whole table into the stream's
    ``synced`` frame and ship per-event additions in order, so both
    sides' tables stay id-aligned without any retraction protocol."""

    __slots__ = ("entries", "_ids", "cap")

    def __init__(self, cap: int = DELTA_VOCAB_MAX):
        self.entries: List[Any] = []
        self._ids: Dict[Any, int] = {}
        self.cap = cap

    def intern(self, enc: Any) -> Optional[int]:
        """Table id for an encoded value worth interning (str, or the
        tagged enum form), or None when it must ship raw — not an
        internable shape, or the table is at cap."""
        if isinstance(enc, str):
            key: Any = enc
        elif isinstance(enc, dict) and len(enc) == 2 and _E in enc:
            key = (_E, enc[_E], enc["v"])
        else:
            return None
        i = self._ids.get(key)
        if i is None:
            if len(self.entries) >= self.cap:
                return None
            i = len(self.entries)
            self._ids[key] = i
            self.entries.append(enc)
        return i

    def snapshot(self) -> List[Any]:
        return list(self.entries)


def object_key(obj: Any) -> str:
    """The store bucket key of a model object ('<ns>/<name>', or bare
    name for unnamespaced kinds) — what a patch's ``dk`` id resolves to
    on both sides of the wire."""
    ns = getattr(obj, "namespace", None)
    return f"{ns}/{obj.name}" if ns is not None else obj.name


def delta_diff(enc_new: Any, enc_old: Any) -> Optional[Tuple[dict, list]]:
    """Field-sparse diff of two sparse-encoded ({__t, f}) forms of the
    same object: ``(changed {field: wire value}, cleared [field, ...])``
    where *cleared* fields went back to their class defaults (encode()
    omitted them). None when the dialect cannot express the change —
    either side is not a tagged dataclass form, or the class changed."""
    if not (isinstance(enc_new, dict) and isinstance(enc_old, dict)):
        return None
    tag = enc_new.get(_T)
    if tag is None or tag != enc_old.get(_T):
        return None
    fnew, fold = enc_new["f"], enc_old["f"]
    changed = {k: v for k, v in fnew.items()
               if k not in fold or fold[k] != v}
    cleared = [k for k in fold if k not in fnew]
    return changed, cleared


def delta_value(enc: Any, interner: Interner) -> Any:
    """Wire form of one changed field's encoded value: an {"__i": id}
    reference for interned hot immutables, the raw encoded value
    otherwise — escaped when a genuine single-key user dict could be
    mistaken for a reference."""
    i = interner.intern(enc)
    if i is not None:
        return {_I: i}
    if isinstance(enc, dict) and len(enc) == 1 and _I in enc:
        return {_D: enc}
    return enc


def delta_resolve(v: Any, table: List[Any]) -> Any:
    """One wire value back to a model value: interned references hit the
    table's pre-decoded cache (so a phase flip pays zero decode); raw
    values go through decode(). IndexError on an unknown reference — the
    caller's typed ``schema_skew`` fallback."""
    if isinstance(v, dict) and len(v) == 1 and _I in v:
        return table[v[_I]]
    return decode(v)


#: per dataclass: field name -> dataclasses.Field (clearing support)
_FIELD_MAP: Dict[type, Dict[str, Any]] = {}


def field_default(cls: type, name: str) -> Any:
    """A fresh default for clearing field ``name`` back to its class
    default (fresh container per call: cleared fields must never share
    mutable state across objects). ValueError when the field has no
    default — a patch clearing a required field is schema skew."""
    fmap = _FIELD_MAP.get(cls)
    if fmap is None:
        fmap = _FIELD_MAP[cls] = {
            f.name: f for f in dataclasses.fields(cls)}
    f = fmap.get(name)
    if f is None:
        raise ValueError(f"{cls.__name__} has no field {name!r}")
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        return f.default_factory()  # type: ignore[misc]
    raise ValueError(
        f"field {cls.__name__}.{name} has no default to clear to")
