"""The port's wire codec (volcano_tpu_torch.client.codec) against the JAX
package's, on the CPU.

- Every model class of the codec's registry (batch and bus included): an
  instance with every field set from a seeded numpy Generator, built in
  each package, encodes to the same JSON (``json.dumps(...,
  sort_keys=True)``), decodes back to an equal object in its own package
  and, across, into the other package's class of that name; an instance
  with every field at its default encodes alike too (the sparse form).
- The cases of tests/test_netstore.py::TestCodec through the port.
- The delta dialect: ``delta_diff``, ``Interner`` / ``delta_value``,
  ``delta_resolve`` and ``field_default`` on a seeded sequence of
  updates, and the store server's ``DeltaEncoder`` frames (their
  serialized bytes), identical in both packages.

Tolerance: exact (JSON text, bytes, equality).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import typing

import numpy as np
import pytest

from torch_helpers import pkg_mod

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

PKGS = ("jax", "torch")


def _codec(pkg):
    return pkg_mod(pkg, "client.codec")


def _dump(x) -> str:
    return json.dumps(x, sort_keys=True)


CLASSES = sorted(n for n, c in _codec("torch")._REGISTRY.items()
                 if dataclasses.is_dataclass(c))
ENUMS = sorted(n for n, c in _codec("torch")._REGISTRY.items()
               if isinstance(c, type) and issubclass(c, enum.Enum))


def _fill(tp, rng, depth, reg, label):
    """A seeded non-default value of annotation ``tp`` (dataclasses and
    enums resolved in the registry ``reg`` of one package)."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return _fill(args[0], rng, depth, reg, label)
    if origin in (list, tuple):
        (item,) = typing.get_args(tp) or (str,)
        return [_fill(item, rng, depth + 1, reg, f"{label}{i}")
                for i in range(2)]
    if origin is dict:
        key_tp, val_tp = typing.get_args(tp) or (str, typing.Any)
        return {f"{label}-k{i}": _fill(val_tp, rng, depth + 1, reg,
                                       f"{label}{i}") for i in range(2)}
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        return populate(reg[tp.__name__], rng, reg, depth + 1)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        members = list(reg[tp.__name__])
        return members[int(rng.integers(0, len(members)))]
    if tp is bool:
        return True
    if tp is int:
        return int(rng.integers(1, 1000))
    if tp is float:
        return float(rng.integers(1, 10 ** 6)) / 8.0
    if tp is bytes:
        return bytes(rng.integers(0, 256, 6).astype(np.uint8).tolist())
    if tp is typing.Any:
        return {"v": f"{label}-any", "n": int(rng.integers(0, 9))}
    return f"{label}-{int(rng.integers(0, 10 ** 6))}"


def populate(cls, rng, reg, depth: int = 0):
    """Every field of dataclass ``cls`` set from ``rng``."""
    hints = typing.get_type_hints(cls)
    kw = {f.name: _fill(hints[f.name], rng, depth, reg, f.name)
          for f in dataclasses.fields(cls)}
    return cls(**kw)


def _pin(obj):
    """Pin the fields a default factory makes fresh per call (uids, clock
    readings), nested ones included, so both packages agree."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            _pin(v)
        elif f.name == "uid":
            setattr(obj, f.name, "uid-pinned")
        elif isinstance(v, float) and v > 1e9:
            setattr(obj, f.name, 1.5)
    return obj


def defaults(cls):
    """``cls`` at its defaults (required fields "x"), fresh values
    pinned."""
    return _pin(cls(**{
        f.name: "x" for f in dataclasses.fields(cls)
        if f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING}))


def both(fn):
    return {pkg: fn(pkg) for pkg in PKGS}


class TestEveryClass:
    @pytest.mark.parametrize("name", CLASSES)
    def test_populated_same_json_and_roundtrip(self, name):
        objs = both(lambda pkg: populate(
            _codec(pkg)._REGISTRY[name], np.random.default_rng(9),
            _codec(pkg)._REGISTRY))
        enc = {pkg: _codec(pkg).encode(o) for pkg, o in objs.items()}
        assert _dump(enc["torch"]) == _dump(enc["jax"])
        for pkg in PKGS:
            other = "jax" if pkg == "torch" else "torch"
            back = _codec(pkg).decode(json.loads(_dump(enc[other])))
            assert type(back) is _codec(pkg)._REGISTRY[name]
            assert back == objs[pkg]

    @pytest.mark.parametrize("name", CLASSES)
    def test_defaults_same_sparse_json(self, name):
        enc = both(lambda pkg: _codec(pkg).encode(
            defaults(_codec(pkg)._REGISTRY[name])))
        assert _dump(enc["torch"]) == _dump(enc["jax"])
        assert _codec("torch").decode(enc["jax"]) == defaults(
            _codec("torch")._REGISTRY[name])

    @pytest.mark.parametrize("name", ENUMS)
    def test_enum_members_same_json(self, name):
        for pkg, member_sets in both(lambda pkg: list(
                _codec(pkg)._REGISTRY[name])).items():
            assert [_dump(_codec(pkg).encode(m)) for m in member_sets] == [
                _dump(_codec("jax").encode(m)) for m in
                _codec("jax")._REGISTRY[name]]
        for m in _codec("torch")._REGISTRY[name]:
            assert _codec("torch").decode(_codec("jax").encode(
                _codec("jax")._REGISTRY[name](m.value))) is m

    def test_registries_name_the_same_classes(self):
        assert sorted(_codec("torch")._REGISTRY) == sorted(
            _codec("jax")._REGISTRY)
        for name in ("Job", "JobSpec", "TaskSpec", "LifecyclePolicy",
                     "Command", "Action", "Event"):
            assert name in CLASSES + ENUMS  # batch and bus


# -- tests/test_netstore.py::TestCodec through the port ----------------------

M = pkg_mod("torch", "models")
C = _codec("torch")
ANN = pkg_mod("torch", "api").POD_GROUP_ANNOTATION


class TestCodec:
    def test_pod_roundtrip(self):
        pod = M.Pod(name="p0", namespace="ns1", node_name="n3",
                    phase="Running", annotations={ANN: "pg1"},
                    containers=[{"requests": {"cpu": "2",
                                              "memory": "4Gi"}}])
        pod.volumes = [{"name": "v", "persistentVolumeClaim":
                        {"claimName": "c1"}}]
        out = C.decode(C.encode(pod))
        assert isinstance(out, M.Pod)
        assert out.name == "p0" and out.node_name == "n3"
        assert out.containers == pod.containers
        assert out.volumes == pod.volumes
        assert out.creation_timestamp == pod.creation_timestamp

    def test_podgroup_enum_and_conditions_roundtrip(self):
        pg = M.PodGroup(name="pg1", namespace="ns1",
                        spec=M.PodGroupSpec(min_member=3))
        pg.status.phase = M.PodGroupPhase.INQUEUE
        pg.status.conditions.append(M.PodGroupCondition(
            type="Scheduled", status="True", transition_id="t1"))
        out = C.decode(C.encode(pg))
        assert isinstance(out, M.PodGroup)
        assert out.status.phase is M.PodGroupPhase.INQUEUE
        assert out.spec.min_member == 3
        assert out.status.conditions[0].type == "Scheduled"

    def test_job_spec_roundtrip(self):
        job = M.Job(name="j", namespace="d")
        job.status.state.phase = M.JobPhase.RUNNING
        out = C.decode(C.encode(job))
        assert isinstance(out, M.Job)
        assert out.status.state.phase is M.JobPhase.RUNNING

    def test_secret_bytes_roundtrip(self):
        sec = M.Secret(name="s1", namespace="d",
                       data={"id_rsa": b"\x00private\xff",
                             "config": b"StrictHostKeyChecking no\n"})
        out = C.decode(C.encode(sec))
        assert isinstance(out, M.Secret)
        assert out.data["id_rsa"] == b"\x00private\xff"
        assert out.data["config"] == b"StrictHostKeyChecking no\n"

    def test_decode_rejects_unknown_class(self):
        with pytest.raises(ValueError):
            C.decode({"__t": "os.system", "f": {}})

    def test_reserved_key_dict_escaped_alike(self):
        cm = both(lambda pkg: pkg_mod(pkg, "models").ConfigMap(
            name="c", data={"__t": "Pod", "__i": "1"}))
        enc = {pkg: _codec(pkg).encode(o) for pkg, o in cm.items()}
        assert _dump(enc["torch"]) == _dump(enc["jax"])
        assert C.decode(enc["jax"]).data == {"__t": "Pod", "__i": "1"}


# -- the delta dialect --------------------------------------------------------

def _pod_history(pkg, steps: int = 24):
    """A seeded pod's successive states (phase flips, binds, label and
    condition churn, fields cleared back to their defaults)."""
    m = pkg_mod(pkg, "models")
    rng = np.random.default_rng(17)
    pod = m.Pod(name="w-0", namespace="ns", uid="pod-w-0",
                creation_timestamp=2.0, annotations={ANN: "w"},
                containers=[{"requests": {"cpu": "1"}}])
    out = [pod]
    for _ in range(steps):
        nxt = dataclasses.replace(pod)
        op = int(rng.integers(0, 5))
        if op == 0:
            nxt.phase = ["Pending", "Running", "Succeeded"][
                int(rng.integers(0, 3))]
        elif op == 1:
            nxt.node_name = "" if pod.node_name else \
                f"n{int(rng.integers(0, 4))}"
        elif op == 2:
            nxt.labels = {} if pod.labels else {"tier": "a"}
        elif op == 3:
            nxt.conditions = [{"type": "Ready",
                               "status": str(bool(rng.integers(0, 2)))}]
        else:
            nxt.priority = None if pod.priority is not None else \
                int(rng.integers(0, 9))
        nxt.resource_version = pod.resource_version + 1
        out.append(nxt)
        pod = nxt
    return out


class TestDeltaDialect:
    def test_diff_and_interned_values_identical(self):
        rows = {}
        for pkg in PKGS:
            codec = _codec(pkg)
            it = codec.Interner()
            hist = _pod_history(pkg)
            seq = []
            for old, new in zip(hist, hist[1:]):
                changed, cleared = codec.delta_diff(codec.encode(new),
                                                    codec.encode(old))
                seq.append([sorted(changed), sorted(cleared),
                            {k: codec.delta_value(v, it)
                             for k, v in sorted(changed.items())}])
            rows[pkg] = (_dump(seq), it.snapshot())
        assert rows["torch"] == rows["jax"]

    def test_resolve_and_field_default(self):
        for pkg in PKGS:
            codec = _codec(pkg)
            table = ["Running"]
            assert codec.delta_resolve({"__i": 0}, table) == "Running"
            with pytest.raises(IndexError):
                codec.delta_resolve({"__i": 3}, table)
            pod_cls = pkg_mod(pkg, "models").Pod
            assert codec.field_default(pod_cls, "labels") == {}
            with pytest.raises(ValueError):
                codec.field_default(pod_cls, "name")
        for pkg in PKGS:
            codec = _codec(pkg)
            it = codec.Interner(cap=2)
            assert [it.intern(x) for x in ("a", "b", "c", "a")] == [
                0, 1, None, 0]
            assert codec.delta_value({"__i": 5}, it) == {"__d": {"__i": 5}}

    def test_delta_encoder_frames_byte_identical(self):
        frames = {}
        for pkg in PKGS:
            enc = pkg_mod(pkg, "client.server").DeltaEncoder()
            hist = _pod_history(pkg)
            out = [enc.payload("pods", None, 1, "add", hist[0], None)["_raw"]]
            for rv, (old, new) in enumerate(zip(hist, hist[1:]), start=2):
                out.append(enc.payload("pods", None, rv, "update", new,
                                       old)["_raw"])
            out.append(_dump(enc.synced_fields(["pods"], None)))
            frames[pkg] = out
        assert frames["torch"] == frames["jax"]
