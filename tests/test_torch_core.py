"""The port's core modules: every scheduler policy on a prioritized DAG, the
data repository's retire protocol, termination detection and the VP map."""

import numpy as np
import pytest

from parsec_tpu_torch.core import scheduler as sched_mod
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.core.datarepo import DataRepo
from parsec_tpu_torch.core.task import Taskpool
from parsec_tpu_torch.core.termdet import LocalTermdet, UserTriggerTermdet
from parsec_tpu_torch.core.vpmap import VPMap
from parsec_tpu_torch.data.data import DataCopy
from parsec_tpu_torch.data.matrix import collection_from_numpy
from parsec_tpu_torch.dsl.dtd import DTDTaskpool
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd


def test_all_reference_schedulers_are_ported():
    assert sched_mod.available() == sorted(
        ["lfq", "gd", "ltq", "lhq", "ap", "pbq", "ip", "ll", "llp", "rnd",
         "spq"])


@pytest.mark.parametrize("name", sched_mod.available())
@pytest.mark.parametrize("nb_cores", [1, 3])
def test_potrf_under_every_scheduler(name, nb_cores):
    """Each policy runs the prioritized POTRF DAG to the right factor, on
    one stream and with worker threads."""
    spd = make_spd(96, seed=5)
    ctx = Context(nb_cores=nb_cores, scheduler=name, device="cpu")
    try:
        P = collection_from_numpy("P", spd, 32, 32)
        tp = DTDTaskpool(ctx, "potrf")
        n = insert_potrf_tasks(tp, P)
        tp.wait(); tp.close(); ctx.wait()
        assert tp.executed == n == 10
    finally:
        ctx.fini()
    L = np.tril(P.to_dense())
    assert np.abs(L @ L.T - spd).max() < 1e-4


def test_datarepo_retires_after_last_use():
    repo = DataRepo(nb_flows=2)
    released = []

    class Copy(DataCopy):
        def release(self):
            released.append(self)

    e = repo.lookup_entry_and_create(("t", 1))
    e.data[0] = Copy(None, 0, "payload")
    repo.entry_addto_usage_limit(("t", 1), 2)
    repo.entry_used_once(("t", 1))
    assert len(repo) == 1 and not released
    repo.entry_used_once(("t", 1))
    assert len(repo) == 0 and repo.retired == 1 and len(released) == 1


def test_local_termdet_waits_for_ready_then_counters():
    tp = Taskpool("t")
    done = []
    tp.on_complete = lambda _tp: done.append(True)
    LocalTermdet().monitor_taskpool(tp)
    tp.termdet.taskpool_state_changed(tp)
    assert not done                        # not ready yet: never declared
    tp.addto_nb_tasks(1)
    tp.termdet.taskpool_ready(tp)
    assert not done
    tp.addto_nb_tasks(-1)
    assert done == [True] and tp.completed


def test_user_trigger_termdet_declares_once():
    tp = Taskpool("u")
    done = []
    tp.on_complete = lambda _tp: done.append(True)
    td = UserTriggerTermdet()
    td.monitor_taskpool(tp)
    td.taskpool_ready(tp)
    td.trigger(tp)
    td.trigger(tp)
    assert done == [True]


@pytest.mark.parametrize("spec,nb_vps", [("flat", 1), ("rr", 4),
                                         ("nb:2:2", 2)])
def test_vpmap_specs(spec, nb_vps):
    vm = VPMap(spec, nb_threads=4)
    assert vm.nb_vps == nb_vps
    assert vm.thread_to_vp(0) == 0
