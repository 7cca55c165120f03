"""DRF plugin: dominant-resource fairness (reference plugins/drf/drf.go:41-663).

Three modes, all reimplemented faithfully:
- plain: per-job dominant share ordering + share-based preemption;
- namespace-weighted: namespace order by share/weight, namespace-aware
  preemption policy;
- hierarchical (hdrf): queue-path tree with weighted shares and
  saturation-aware scaling; queue order + reclaimable by hierarchical
  comparison. Incompatible with the proportion plugin (conf loader rejects).

Shares are maintained incrementally through session event handlers, exactly
like the reference, so they stay consistent with every allocate/evict the
solver replays through the Statement boundary.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from ..api import Resource, TaskStatus
from ..framework import Arguments, EventHandler, Plugin
from ..metrics import metrics

SHARE_DELTA = 0.000001


def share(l: float, r: float) -> float:
    if r == 0:
        return 0.0 if l == 0 else 1.0
    return l / r


class _DrfAttr:
    __slots__ = ("share", "dominant_resource", "allocated")

    def __init__(self, allocated: Optional[Resource] = None):
        self.share = 0.0
        self.dominant_resource = ""
        self.allocated = allocated if allocated is not None else Resource()


class _HNode:
    """Hierarchical-tree node (drf.go:41-91)."""

    def __init__(self, hierarchy: str, weight: float = 1.0,
                 attr: Optional[_DrfAttr] = None, request=None,
                 children: Optional[dict] = None):
        self.parent = None
        self.attr = attr if attr is not None else _DrfAttr()
        self.request = request if request is not None else Resource()
        self.weight = weight
        self.saturated = False
        self.hierarchy = hierarchy
        self.children: Optional[Dict[str, _HNode]] = children

    def clone(self, parent=None) -> "_HNode":
        n = _HNode(self.hierarchy, self.weight)
        n.parent = parent
        n.attr = _DrfAttr(self.attr.allocated.clone())
        n.attr.share = self.attr.share
        n.attr.dominant_resource = self.attr.dominant_resource
        n.request = self.request.clone()
        n.saturated = self.saturated
        if self.children is not None:
            n.children = {c.hierarchy: c.clone(n)
                          for c in self.children.values()}
        return n


def _resource_saturated(allocated: Resource, job_request: Resource,
                        demanding: Dict[str, bool]) -> bool:
    for rn in allocated.resource_names():
        alloc, req = allocated.get(rn), job_request.get(rn)
        if alloc != 0 and req != 0 and alloc >= req:
            return True
        if not demanding.get(rn, False) and req != 0:
            return True
    return False


class DRFPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = Arguments(arguments or {})
        self.total_resource = Resource()
        self.total_allocated = Resource()
        self.job_attrs: Dict[str, _DrfAttr] = {}
        self.namespace_opts: Dict[str, _DrfAttr] = {}
        self.hierarchical_root = _HNode("root", 1.0, children={})

    def name(self) -> str:
        return "drf"

    # -- mode flags (plugin option enables) ---------------------------------

    def _hierarchy_enabled(self, ssn) -> bool:
        for tier in ssn.tiers:
            for opt in tier.plugins:
                if opt.name == self.name():
                    return bool(opt.arguments.get("drf.enableHierarchy")) \
                        or bool(getattr(opt, "enabled_hierarchy", False))
        return False

    def _namespace_order_enabled(self, ssn) -> bool:
        for tier in ssn.tiers:
            for opt in tier.plugins:
                if opt.name == self.name():
                    return bool(opt.enabled_namespace_order)
        return False

    # -- share math ---------------------------------------------------------

    def calculate_share(self, allocated: Resource, total: Resource):
        res, dominant = 0.0, ""
        for rn in total.resource_names():
            s = share(allocated.get(rn), total.get(rn))
            if s > res:
                res, dominant = s, rn
        return dominant, res

    def _update_share(self, attr: _DrfAttr) -> None:
        attr.dominant_resource, attr.share = self.calculate_share(
            attr.allocated, self.total_resource)

    def _update_job_share(self, job_ns, job_name, attr) -> None:
        self._update_share(attr)
        metrics.job_share.set(attr.share,
                              {"job_ns": job_ns, "job_id": job_name})

    def _update_namespace_share(self, ns, attr) -> None:
        self._update_share(attr)
        metrics.namespace_share.set(attr.share, {"namespace_name": ns})

    # -- hierarchy ----------------------------------------------------------

    def _build_hierarchy(self, root: _HNode, job, attr: _DrfAttr,
                         hierarchy: str, weights: str) -> None:
        inode = root
        paths = hierarchy.split("/")
        wparts = weights.split("/")
        for i in range(1, len(paths)):
            child = (inode.children or {}).get(paths[i])
            if child is None:
                try:
                    fweight = float(wparts[i])
                except (IndexError, ValueError):
                    fweight = 1.0
                fweight = max(fweight, 1.0)
                child = _HNode(paths[i], fweight, children={})
                child.parent = inode
                inode.children[paths[i]] = child
            inode = child
        leaf = _HNode(str(job.uid), 1.0, attr,
                      request=job.total_request.clone(), children=None)
        inode.children[str(job.uid)] = leaf

    def _update_hierarchical_share(self, node: _HNode,
                                   demanding: Dict[str, bool]) -> None:
        if node.children is None:
            node.saturated = _resource_saturated(
                node.attr.allocated, node.request, demanding)
            return
        mdr = 1.0
        for child in node.children.values():
            self._update_hierarchical_share(child, demanding)
            if child.attr.share != 0 and not child.saturated:
                _, res_share = self.calculate_share(
                    child.attr.allocated, self.total_resource)
                if res_share < mdr:
                    mdr = res_share
        node.attr.allocated = Resource()
        saturated = True
        for child in node.children.values():
            if not child.saturated:
                saturated = False
            if child.attr.share != 0:
                if child.saturated:
                    node.attr.allocated.add(child.attr.allocated)
                else:
                    node.attr.allocated.add(
                        child.attr.allocated.clone().scale(
                            mdr / child.attr.share))
        node.attr.dominant_resource, node.attr.share = self.calculate_share(
            node.attr.allocated, self.total_resource)
        node.saturated = saturated

    def update_hierarchical_share(self, root, total_allocated, job, attr,
                                  hierarchy, weights) -> None:
        demanding = {}
        for rn in self.total_resource.resource_names():
            if total_allocated.get(rn) < self.total_resource.get(rn):
                demanding[rn] = True
        self._build_hierarchy(root, job, attr, hierarchy, weights)
        self._update_hierarchical_share(root, demanding)

    def _compare_queues(self, root: _HNode, lqueue, rqueue) -> float:
        lnode, rnode = root, root
        lpaths = lqueue.hierarchy.split("/")
        rpaths = rqueue.hierarchy.split("/")
        depth = min(len(lpaths), len(rpaths))
        for i in range(depth):
            if not lnode.saturated and rnode.saturated:
                return -1
            if lnode.saturated and not rnode.saturated:
                return 1
            lkey = lnode.attr.share / lnode.weight
            rkey = rnode.attr.share / rnode.weight
            if lkey == rkey:
                if i < depth - 1:
                    lnode = (lnode.children or {}).get(lpaths[i + 1])
                    rnode = (rnode.children or {}).get(rpaths[i + 1])
                    if lnode is None or rnode is None:
                        return 0
            else:
                return lkey - rkey
        return 0

    # -- session wiring -----------------------------------------------------

    def on_session_open(self, ssn) -> None:
        from ..api import allocated_status

        self.total_resource = ssn.total_allocatable().clone()

        # feed the solver: per-round dominant-share job ordering runs as
        # on-device reductions (SURVEY §7 stage 4); allocate fills the
        # flatten's job_drf_allocated/drf_total arrays from these attrs.
        # Honors the tier's enabledJobOrder gate like the host dispatch
        # (session.py _tier_fns), so a config that disabled DRF ordering
        # doesn't get it back on the solver path.
        from ..framework.session import _enabled
        if any(opt.name == self.name()
               and _enabled(opt, "enabled_job_order")
               for tier in ssn.tiers for opt in tier.plugins):
            ssn.solver_options["drf_order"] = {
                "job_attrs": self.job_attrs,
                "total": self.total_resource,
                # hdrf: the allocate action builds the queue-path tree
                # arrays (ops.hdrf) and the kernel re-ranks by the
                # hierarchical comparator instead of plain shares
                "hierarchy": self._hierarchy_enabled(ssn),
                "total_allocated": self.total_allocated,
            }

        namespace_order = self._namespace_order_enabled(ssn)
        hierarchy = self._hierarchy_enabled(ssn)

        for job in ssn.jobs.values():
            # JobInfo.allocated is the maintained sum over allocated-status
            # tasks — the same set drf.go:201-214 iterates — so the session
            # open is O(jobs), not O(tasks)
            attr = _DrfAttr(job.allocated.clone())
            self.job_attrs[job.uid] = attr
            # plain mode orders only jobs with Pending tasks, and the
            # victim fns recompute shares from attr.allocated on the fly,
            # so the per-job share precompute (+ gauge write) is skipped
            # for the steady-state bulk of running jobs; namespace and
            # hierarchy modes aggregate over every job and keep it
            if namespace_order or hierarchy \
                    or TaskStatus.PENDING in job.task_status_index:
                self._update_job_share(job.namespace, job.name, attr)

            if namespace_order:
                ns_opt = self.namespace_opts.setdefault(
                    job.namespace, _DrfAttr())
                ns_opt.allocated.add(attr.allocated)
                self._update_namespace_share(job.namespace, ns_opt)
            if hierarchy:
                queue = ssn.queues.get(job.queue)
                if queue is not None:
                    self.total_allocated.add(attr.allocated)
                    self.update_hierarchical_share(
                        self.hierarchical_root, self.total_allocated, job,
                        attr, queue.hierarchy, queue.weights)

        def preemptable_fn(preemptor, preemptees):
            victims = []
            pool = preemptees
            if namespace_order:
                l_ns_info = ssn.namespace_info.get(preemptor.namespace)
                l_weight = l_ns_info.get_weight() if l_ns_info else 1
                l_att = self.namespace_opts.get(preemptor.namespace, _DrfAttr())
                l_alloc = l_att.allocated.clone().add(preemptor.resreq)
                _, l_share = self.calculate_share(l_alloc, self.total_resource)
                l_weighted = l_share / l_weight

                ns_allocation: Dict[str, Resource] = {}
                undecided = []
                for preemptee in pool:
                    if preemptor.namespace == preemptee.namespace:
                        undecided.append(preemptee)
                        continue
                    if preemptee.namespace not in ns_allocation:
                        r_att = self.namespace_opts.get(
                            preemptee.namespace, _DrfAttr())
                        ns_allocation[preemptee.namespace] = \
                            r_att.allocated.clone()
                    r_ns_info = ssn.namespace_info.get(preemptee.namespace)
                    r_weight = r_ns_info.get_weight() if r_ns_info else 1
                    r_alloc = ns_allocation[preemptee.namespace]
                    try:
                        r_alloc.sub(preemptee.resreq)
                    except ValueError:
                        r_alloc = Resource()
                    _, r_share = self.calculate_share(
                        r_alloc, self.total_resource)
                    r_weighted = r_share / r_weight
                    if l_weighted < r_weighted:
                        victims.append(preemptee)
                        continue
                    if l_weighted - r_weighted > SHARE_DELTA:
                        continue
                    undecided.append(preemptee)
                pool = undecided

            l_att = self.job_attrs.get(preemptor.job, _DrfAttr())
            l_alloc = l_att.allocated.clone().add(preemptor.resreq)
            _, ls = self.calculate_share(l_alloc, self.total_resource)
            allocations: Dict[str, Resource] = {}
            for preemptee in pool:
                if preemptee.job not in allocations:
                    r_att = self.job_attrs.get(preemptee.job, _DrfAttr())
                    allocations[preemptee.job] = r_att.allocated.clone()
                r_alloc = allocations[preemptee.job]
                try:
                    r_alloc.sub(preemptee.resreq)
                except ValueError:
                    pass
                _, rs = self.calculate_share(r_alloc, self.total_resource)
                if ls < rs or abs(ls - rs) <= SHARE_DELTA:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name(), preemptable_fn)

        if hierarchy:
            def queue_order_fn(l, r):
                ret = self._compare_queues(self.hierarchical_root, l, r)
                return -1 if ret < 0 else (1 if ret > 0 else 0)

            ssn.add_queue_order_fn(self.name(), queue_order_fn)

            def reclaimable_fn(reclaimer, reclaimees):
                victims = []
                total_allocated = self.total_allocated.clone()
                root = self.hierarchical_root.clone()
                ljob = ssn.jobs.get(reclaimer.job)
                lqueue = ssn.queues.get(ljob.queue)
                lattr = _DrfAttr(self.job_attrs[ljob.uid].allocated.clone())
                lattr.allocated.add(reclaimer.resreq)
                total_allocated.add(reclaimer.resreq)
                self._update_share(lattr)
                self.update_hierarchical_share(
                    root, total_allocated, ljob.clone(), lattr,
                    lqueue.hierarchy, lqueue.weights)
                for preemptee in reclaimees:
                    rjob = ssn.jobs.get(preemptee.job)
                    rqueue = ssn.queues.get(rjob.queue)
                    try:
                        total_allocated.sub(preemptee.resreq)
                    except ValueError:
                        pass
                    rattr = _DrfAttr(
                        self.job_attrs[rjob.uid].allocated.clone())
                    try:
                        rattr.allocated.sub(preemptee.resreq)
                    except ValueError:
                        pass
                    self._update_share(rattr)
                    self.update_hierarchical_share(
                        root, total_allocated, rjob.clone(), rattr,
                        rqueue.hierarchy, rqueue.weights)
                    ret = self._compare_queues(root, lqueue, rqueue)
                    # restore
                    total_allocated.add(preemptee.resreq)
                    rattr.allocated.add(preemptee.resreq)
                    self._update_share(rattr)
                    self.update_hierarchical_share(
                        root, total_allocated, rjob.clone(), rattr,
                        rqueue.hierarchy, rqueue.weights)
                    if ret < 0:
                        victims.append(preemptee)
                return victims

            ssn.add_reclaimable_fn(self.name(), reclaimable_fn)

        def job_order_fn(l, r):
            ls = self.job_attrs[l.uid].share
            rs = self.job_attrs[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_job_order_fn(self.name(), job_order_fn)
        ssn.add_order_key_fn("job_order_fns", self.name(),
                             lambda j: self.job_attrs[j.uid].share)
        # the share key is live-share-dependent: share = f(job.allocated,
        # cluster total). job.allocated churn is version-gated (the
        # OrderCache re-keys dirty jobs), but the TOTAL is cluster-wide
        # state — declare it as the key's context so a node add/remove/
        # respec invalidates every cached share-ordered position instead
        # of silently re-ranking only the churned jobs
        total = self.total_resource
        ssn.add_order_key_context_fn(
            "job_order_fns", self.name(),
            lambda: (total.milli_cpu, total.memory,
                     tuple(sorted(total.scalars.items()))))

        if namespace_order:
            def namespace_order_fn(l, r):
                l_opt = self.namespace_opts.get(l, _DrfAttr())
                r_opt = self.namespace_opts.get(r, _DrfAttr())
                l_info = ssn.namespace_info.get(l)
                r_info = ssn.namespace_info.get(r)
                lw = l_info.get_weight() if l_info else 1
                rw = r_info.get_weight() if r_info else 1
                lws, rws = l_opt.share / lw, r_opt.share / rw
                metrics.namespace_weight.set(lw, {"namespace_name": str(l)})
                metrics.namespace_weight.set(rw, {"namespace_name": str(r)})
                if lws == rws:
                    return 0
                return -1 if lws < rws else 1

            ssn.add_namespace_order_fn(self.name(), namespace_order_fn)

        def on_allocate(event):
            attr = self.job_attrs.get(event.task.job)
            if attr is None:
                return
            attr.allocated.add(event.task.resreq)
            job = ssn.jobs.get(event.task.job)
            self._update_job_share(job.namespace, job.name, attr)
            if namespace_order:
                ns_opt = self.namespace_opts.setdefault(
                    event.task.namespace, _DrfAttr())
                ns_opt.allocated.add(event.task.resreq)
                self._update_namespace_share(event.task.namespace, ns_opt)
            if hierarchy:
                queue = ssn.queues.get(job.queue)
                if queue is not None:
                    self.total_allocated.add(event.task.resreq)
                    self.update_hierarchical_share(
                        self.hierarchical_root, self.total_allocated, job,
                        attr, queue.hierarchy, queue.weights)

        def on_deallocate(event):
            attr = self.job_attrs.get(event.task.job)
            if attr is None:
                return
            try:
                attr.allocated.sub(event.task.resreq)
            except ValueError:
                pass
            job = ssn.jobs.get(event.task.job)
            self._update_job_share(job.namespace, job.name, attr)
            if namespace_order:
                ns_opt = self.namespace_opts.setdefault(
                    event.task.namespace, _DrfAttr())
                try:
                    ns_opt.allocated.sub(event.task.resreq)
                except ValueError:
                    pass
                self._update_namespace_share(event.task.namespace, ns_opt)
            if hierarchy:
                queue = ssn.queues.get(job.queue)
                if queue is not None:
                    try:
                        self.total_allocated.sub(event.task.resreq)
                    except ValueError:
                        pass
                    self.update_hierarchical_share(
                        self.hierarchical_root, self.total_allocated, job,
                        attr, queue.hierarchy, queue.weights)

        def on_allocate_batch(tasks):
            """Additive form of on_allocate: one aggregate add + one share
            recompute per job (shares depend only on totals)."""
            by_job: Dict[str, list] = {}
            for t in tasks:
                group = by_job.get(t.job)
                if group is None:
                    by_job[t.job] = [t]
                else:
                    group.append(t)
            for juid, group in by_job.items():
                agg = Resource.sum_of(t.resreq for t in group)
                attr = self.job_attrs.get(juid)
                if attr is None:
                    continue
                attr.allocated.add(agg)
                job = ssn.jobs.get(juid)
                self._update_job_share(job.namespace, job.name, attr)
                if namespace_order:
                    ns_opt = self.namespace_opts.setdefault(
                        job.namespace, _DrfAttr())
                    ns_opt.allocated.add(agg)
                    self._update_namespace_share(job.namespace, ns_opt)
                if hierarchy:
                    queue = ssn.queues.get(job.queue)
                    if queue is not None:
                        self.total_allocated.add(agg)
                        self.update_hierarchical_share(
                            self.hierarchical_root, self.total_allocated,
                            job, attr, queue.hierarchy, queue.weights)

        ssn.add_event_handler(EventHandler(
            allocate_func=on_allocate, deallocate_func=on_deallocate,
            batch_allocate_func=on_allocate_batch))

    def on_session_close(self, ssn) -> None:
        self.total_resource = Resource()
        self.total_allocated = Resource()
        self.job_attrs = {}
        self.namespace_opts = {}
        self.hierarchical_root = _HNode("root", 1.0, children={})
