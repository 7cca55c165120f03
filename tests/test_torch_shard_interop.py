"""The port's sharded and replicated store against the JAX package's, on
the CPU: the wire, the shard routing and the per-shard WAL lineages are
the JAX package's byte for byte, so either package's client, router,
worker and replica talk to the other's.

- A port client and a port replica against a JAX ShardRouter, a JAX
  ProcShardRouter (JAX worker processes) and a JAX durable primary, and
  the JAX ones against the port's: CRUD and bulk_apply land as the
  receiving package's classes, a bulk_watch stream delivers them, the
  replica's mirror equals the primary object for object, and a replica
  of the other package tails that replica in turn (a mixed depth-2
  tree through the relay of ``_serve_ship``).
- A 4-shard data directory written by either package's
  ShardedClusterStore, recovered by the other: equal lists and per-shard
  rvs, every object on the shard it was written to.
- The same seeded writes through both packages' sharded stores land on
  the same shards with the same per-shard rvs and objects.

Tolerance: exact (encoded objects, rvs, shard placement).
"""

import json
import time

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

from torch_helpers import PACKAGES, Builders, pkg_mod  # noqa: E402

PKGS = ("jax", "torch")
OTHER = {"jax": "torch", "torch": "jax"}


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in PKGS:
        pkg_mod(pkg, "resilience").faults.reset()
    yield
    for pkg in PKGS:
        pkg_mod(pkg, "resilience").faults.reset()


def wait_until(cond, timeout=30.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def canon(pkg, obj, strip=()) -> str:
    """One object's wire encoding (the encoder of its own package), as
    comparable text; ``strip`` drops fields minted per process."""
    enc = pkg_mod(pkg, "client.codec").encode(obj)
    if strip:
        enc = dict(enc, f={k: v for k, v in (enc.get("f") or {}).items()
                           if k not in strip})
    return json.dumps(enc, sort_keys=True)


def dump(pkg, store, kinds=("pods", "nodes", "queues", "podgroups")):
    out = {}
    for kind in kinds:
        objs = store.list(kind)
        out[kind] = sorted(canon(pkg, o) for o in objs)
    return out


class Primary:
    """One package's primary of a given shape, served on one endpoint:
    ``router`` (ShardedClusterStore(4) behind a ShardRouter), ``proc``
    (4 worker processes behind a ProcShardRouter) or ``durable`` (one
    DurableClusterStore behind a StoreServer); every one durable, so a
    replica can ship from it."""

    def __init__(self, pkg: str, shape: str, data_dir: str):
        c = pkg_mod(pkg, "client")
        self.pkg, self.shape, self.sup = pkg, shape, None
        if shape == "router":
            self.store = c.ShardedClusterStore(4, data_dir=data_dir,
                                               fsync="off")
            self.server = c.ShardRouter(self.store, port=0).start()
        elif shape == "proc":
            self.sup = c.ShardProcSupervisor(
                4, data_dir=data_dir, fsync="off",
                restart_backoff_base_s=0.1).start()
            self.store = c.ProcShardedStore(self.sup)
            self.server = c.ProcShardRouter(self.store, port=0).start()
        else:
            self.store = c.DurableClusterStore(data_dir, fsync="off")
            self.server = c.StoreServer(self.store).start()
        self.address = f"127.0.0.1:{self.server.port}"

    def in_process(self) -> bool:
        return self.shape != "proc"

    def close(self) -> None:
        self.server.stop()
        if self.sup is not None:
            self.sup.stop()
        else:
            self.store.close()


def make_pod(b, i, ns="ns"):
    return b.build_pod(ns, f"p{i}", "", "Pending", {"cpu": "1"}, "pg")


class TestServeAcross:
    @pytest.mark.parametrize("shape", ["router", "proc", "durable"])
    @pytest.mark.parametrize("client_pkg", PKGS)
    def test_client_and_replica_against_other_package(self, tmp_path,
                                                      shape, client_pkg):
        server_pkg = OTHER[client_pkg]
        cli = pkg_mod(client_pkg, "client")
        srv = pkg_mod(server_pkg, "client")
        cb, sb = Builders(client_pkg), Builders(server_pkg)
        primary = Primary(server_pkg, shape, str(tmp_path / "p"))
        closers = []
        try:
            remote = cli.RemoteClusterStore(primary.address,
                                            direct_watch=True)
            closers.append(remote)
            seen = []
            remote.bulk_watch([("pods", lambda e, o, old: seen.append(
                (e, o.name, type(o).__module__.split(".")[0])))])
            remote.create("queues", cb.build_queue("q0", weight=2))
            remote.create("nodes", cb.build_node("n0", {"cpu": "8"}))
            res = remote.bulk_apply([("pods", make_pod(cb, i), "create")
                                     for i in range(24)])
            assert [type(r) for r in res] == [cb.models.Pod] * 24
            pod = remote.get("pods", "p3", "ns")
            assert type(pod) is cb.models.Pod
            pod.node_name, pod.phase = "n0", "Running"
            remote.update("pods", pod)
            remote.delete("pods", "p5", "ns")
            with pytest.raises(cli.NotFoundError):
                remote.get("pods", "p5", "ns")
            if primary.in_process():
                # objects land server-side as the server package's classes
                got = primary.store.get("pods", "p3", "ns")
                assert type(got) is sb.models.Pod and got.node_name == "n0"
            if shape == "proc":
                # direct routing to the other package's workers
                assert remote._n_shards == 4
                assert remote.direct_requests > 0
            assert wait_until(lambda: len(seen) == 24 + 2)
            assert {m for _, _, m in seen} == {PACKAGES[client_pkg]}
            # a client-package replica tails the other package's primary
            rep = cli.ReplicaStore(primary.address)
            closers.append(rep)
            rs = rep.serve()
            rep.start()
            want_rv = remote._request({"op": "store_info"})["rv"]
            assert wait_until(lambda: rep.applied_rv() == want_rv)
            assert dump(client_pkg, rep.store) == dump(client_pkg, remote)
            # and a server-package replica tails that replica: the relay
            # of the client package's _serve_ship from its mirror's ring
            deep = srv.ReplicaStore(rs.address)
            closers.append(deep)
            deep.start()
            assert deep.depth == 2
            for i in range(24, 30):
                remote.create("pods", make_pod(cb, i))
            want_rv = remote._request({"op": "store_info"})["rv"]
            assert wait_until(lambda: rep.applied_rv() == want_rv
                              and deep.applied_rv() == want_rv)
            assert dump(server_pkg, deep.store) == dump(client_pkg, remote)
            assert rep.ship_served["streams"] >= 1
            # reads at the leaf carry the primary's rv
            leaf = srv.RemoteClusterStore(rs.address, direct_routing=False)
            closers.append(leaf)
            pods, applied = leaf.list_versioned("pods", min_rv=want_rv)
            assert applied == want_rv and len(pods) == 29
        finally:
            for c in reversed(closers):
                c.close()
            primary.close()


def seeded_writes(pkg, store, seed: int = 7, n: int = 160) -> None:
    """One seeded sequence of creates, updates and deletes over several
    kinds (the lease pinned to shard 0 included), through ``store``."""
    b = Builders(pkg)
    m = b.models
    rng = np.random.default_rng(seed)
    live = []
    store.create("queues", b.build_queue("q0", weight=1))
    store.create("leases", m.Lease(name="volcano", holder_identity="a",
                                   renew_time=1000.0))
    for i in range(n):
        op = rng.integers(0, 10)
        if op < 5 or not live:
            name = f"p{i}"
            store.create("pods", b.build_pod(
                "ns", name, "", "Pending",
                {"cpu": str(1 + int(rng.integers(0, 4)))}, f"g{i % 7}"))
            live.append(name)
        elif op < 7:
            name = live[int(rng.integers(0, len(live)))]
            pod = store.get("pods", name, "ns")
            pod.node_name, pod.phase = f"n{int(rng.integers(0, 9))}", \
                "Running"
            store.update("pods", pod)
        elif op < 8:
            name = live.pop(int(rng.integers(0, len(live))))
            store.delete("pods", name, "ns")
        elif op < 9:
            store.apply("nodes", b.build_node(
                f"n{int(rng.integers(0, 9))}",
                {"cpu": str(8 + int(rng.integers(0, 8)))}))
        else:
            store.apply("podgroups", b.build_pod_group(
                f"g{int(rng.integers(0, 7))}", "ns",
                min_member=int(rng.integers(1, 4)), queue="q0"))


def shard_view(pkg, store, strip=()) -> list:
    """Per shard: its rv and, per kind, its keys and objects encoded."""
    out = []
    for sh in store.shards:
        out.append({
            "rv": sh._rv,
            "objects": {kind: sorted(canon(pkg, o, strip)
                                     for o in bucket.values())
                        for kind, bucket in sh._buckets.items() if bucket},
            "keys": {kind: sorted(bucket)
                     for kind, bucket in sh._buckets.items() if bucket}})
    return out


class TestShardedLineages:
    @pytest.mark.parametrize("writer", PKGS)
    def test_data_dir_recovered_by_other_package(self, tmp_path, writer):
        reader = OTHER[writer]
        w = pkg_mod(writer, "client").ShardedClusterStore(
            4, data_dir=str(tmp_path), fsync="off", snapshot_every=16)
        seeded_writes(writer, w)
        want = shard_view(writer, w)
        w.close()
        for idx in range(4):
            assert (tmp_path / f"shard-{idx:03d}").is_dir()
        r = pkg_mod(reader, "client").ShardedClusterStore(
            4, data_dir=str(tmp_path), fsync="off", snapshot_every=16)
        try:
            assert shard_view(reader, r) == want
            assert [sh._rv for sh in r.shards] == [s["rv"] for s in want]
            assert sum(sh.recovered_records for sh in r.shards) > 0
            # the recovered lineages go on: the next write continues its
            # shard's rv sequence
            pod = r.create("pods", Builders(reader).build_pod(
                "ns", "after", "", "Pending", {"cpu": "1"}, "g0"))
            idx = r.shard_of("pods", "ns/after")
            assert pod.resource_version == want[idx]["rv"] + 1
        finally:
            r.close()

    def test_same_writes_same_shards_and_rvs(self):
        views = {}
        for pkg in PKGS:
            store = pkg_mod(pkg, "client").ShardedClusterStore(4)
            store.clock = lambda: 1000.0
            seeded_writes(pkg, store)
            # uids and creation times are minted per package and process
            views[pkg] = shard_view(pkg, store,
                                    strip=("uid", "creation_timestamp"))
        assert views["torch"] == views["jax"]
        assert all(v["rv"] > 0 for v in views["torch"])
        # the lease is pinned to shard 0 in both
        assert views["torch"][0]["keys"]["leases"] == ["volcano"]
