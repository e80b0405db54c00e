"""Virtual-process map and thread binding.

Re-design of parsec/vpmap.c + parsec/bindthread.c + the hwloc wrapper
(parsec/parsec_hwloc.c): group worker streams into *virtual processes*
(NUMA-domain-like groups that schedulers steal within first) and bind
threads to cores. Topology discovery uses os.sched_getaffinity; binding uses
os.sched_setaffinity where the platform provides it.

Spec grammar (``--mca runtime_vpmap``), following the reference's modes:

* ``flat``           — one VP with all threads (default)
* ``rr``             — one VP per core, round-robin
* ``nb:<n>:<t>``     — n VPs with t threads each
* ``file:<path>``    — one line per VP: comma-separated core ids
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

from ..utils import mca, output

mca.register("runtime_vpmap", "flat", "VP map spec (flat|rr|nb:<n>:<t>|file:<path>)")
mca.register("runtime_bind_threads", False, "Bind worker threads to cores", type=bool)


def available_cores() -> List[int]:
    try:
        return sorted(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return list(range(os.cpu_count() or 1))


@dataclass
class VP:
    vp_id: int
    cores: List[int] = field(default_factory=list)

    @property
    def nb_threads(self) -> int:
        return len(self.cores)


class VPMap:
    """Ref: parsec_vpmap_init (vpmap.c)."""

    def __init__(self, spec: Optional[str] = None,
                 nb_threads: Optional[int] = None) -> None:
        spec = spec or mca.get("runtime_vpmap", "flat")
        cores = available_cores()
        if nb_threads:
            cores = (cores * ((nb_threads + len(cores) - 1) // len(cores)))[:nb_threads]
        self.vps: List[VP] = []
        if spec == "flat":
            self.vps = [VP(0, list(cores))]
        elif spec == "rr":
            self.vps = [VP(i, [c]) for i, c in enumerate(cores)]
        elif spec.startswith("nb:"):
            try:
                _, n, t = spec.split(":")
                n, t = int(n), int(t)
            except ValueError:
                output.fatal(f"bad vpmap spec {spec!r}")
            it = iter(cores * (1 + (n * t) // max(len(cores), 1)))
            self.vps = [VP(i, [next(it) for _ in range(t)]) for i in range(n)]
        elif spec.startswith("file:"):
            path = spec[5:]
            with open(path) as f:
                for i, line in enumerate(f):
                    line = line.split("#", 1)[0].strip()
                    if not line:
                        continue
                    self.vps.append(VP(len(self.vps),
                                       [int(x) for x in line.split(",")]))
        else:
            output.fatal(f"unknown vpmap spec {spec!r}")
        if not self.vps:
            self.vps = [VP(0, list(cores))]

    @property
    def nb_vps(self) -> int:
        return len(self.vps)

    @property
    def nb_threads(self) -> int:
        return sum(vp.nb_threads for vp in self.vps)

    def thread_to_vp(self, th_id: int) -> int:
        """Map a global thread id to its VP."""
        i = 0
        for vp in self.vps:
            if th_id < i + vp.nb_threads:
                return vp.vp_id
            i += vp.nb_threads
        return self.vps[-1].vp_id

    def core_of(self, th_id: int) -> int:
        i = 0
        for vp in self.vps:
            if th_id < i + vp.nb_threads:
                return vp.cores[th_id - i]
            i += vp.nb_threads
        return self.vps[-1].cores[-1]


_SYS_NODE = "/sys/devices/system/node"


def _parse_cpulist(text: str) -> List[int]:
    """"0-3,7,9-10" -> [0,1,2,3,7,9,10] (the sysfs cpulist format)."""
    out: List[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        if hi:
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(lo))
    return out


def numa_topology(base: str = _SYS_NODE):
    """Discover (core -> NUMA node, node-distance matrix) from sysfs —
    the hwloc-distances role (ref: parsec_hwloc.c distance queries feeding
    the schedulers' steal-locality walk). Single-node / non-Linux hosts
    degrade to one node at self-distance 10 (the ACPI SLIT convention)."""
    core_node: dict = {}
    dists: dict = {}
    try:
        for entry in sorted(os.listdir(base)):
            if not entry.startswith("node") or not entry[4:].isdigit():
                continue
            node = int(entry[4:])
            try:
                with open(os.path.join(base, entry, "cpulist")) as f:
                    for c in _parse_cpulist(f.read()):
                        core_node[c] = node
                with open(os.path.join(base, entry, "distance")) as f:
                    dists[node] = [int(x) for x in f.read().split()]
            except OSError:
                continue
    except OSError:
        pass
    if not core_node:
        for c in available_cores():
            core_node[c] = 0
        dists[0] = [10]
    return core_node, dists


_core_distance_cache = None


def core_distance_fn(base: str = _SYS_NODE):
    """A cached ``f(core_a, core_b) -> int`` over the NUMA distance matrix
    (10 = same node, larger = farther; unknown cores treated as node 0)."""
    global _core_distance_cache
    if _core_distance_cache is None or base != _SYS_NODE:
        core_node, dists = numa_topology(base)
        nodes = sorted(dists)

        def distance(a: int, b: int) -> int:
            na, nb = core_node.get(a, 0), core_node.get(b, 0)
            row = dists.get(na)
            if row is None or nb >= len(row):
                return 10 if na == nb else 20
            # sysfs rows are ordered by target node id
            try:
                return row[nodes.index(nb)]
            except ValueError:
                return 20
        if base != _SYS_NODE:
            return distance
        _core_distance_cache = distance
    return _core_distance_cache


def bind_current_thread(core: int) -> bool:
    """parsec_bindthread: pin the calling thread (best effort)."""
    try:
        os.sched_setaffinity(0, {core})
        return True
    except (AttributeError, OSError) as e:
        output.debug_verbose(2, "bindthread", f"binding to core {core} failed: {e}")
        return False
