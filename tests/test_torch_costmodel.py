"""The port's online cost model (``parsec_tpu_torch/core/costmodel.py``):
the reference's tests/test_costmodel.py on the port, on the CPU.

Layers:

* the model itself: shape-bucket stability, EWMA decay vs a regime change,
  cold-start prior fallback, nearest-bucket answers, one-shot explore
  tickets, persistence keyed by ``device_fingerprint`` (a stale
  fingerprint discards the file);
* the feeding discipline: C-side cost rows fold when the lane graph
  finishes, with EXACT task counts;
* consumer (a) placement: a class measured cheaper on its CPU twin
  diverges from the static has-a-device-body heuristic and the pool skips
  the device lane; a ``time_estimate`` hook seeds the prior instead of
  declining the lane;
* consumer (b) fusion sizing: a measured fused per-task cost >= unfused
  declines the class; a measured first-call cost above the per-member
  saving shrinks the region cap to break-even;
* consumer (c) the serving reconciler's gain: damped when the share error
  grows, boosted while it stalls, frozen by ``--mca costmodel_reconcile 0``.

Cross-checks feed one sequence of observations to both packages' models
(the same placements and the same persisted entries, with ``tpu`` read as
``cuda``) and one sequence of share errors to both packages' reconcilers
(the same gains round by round).
"""

import json

import numpy as np
import pytest

from parsec_tpu_torch.core import costmodel
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.core.costmodel import (COSTMODEL_STATS, CostModel,
                                             shape_bucket)
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS, compile_ptg
from parsec_tpu_torch.utils import mca


@pytest.fixture(autouse=True)
def _fresh_cost_model():
    """The online cost model is process-global by design; every test here
    starts from a cold one (the reference resets its model per test in its
    conftest)."""
    costmodel.model.reset()
    yield
    costmodel.model.reset()


class pt:
    """The reference tests' ``pt.Context`` spelled for the port: a CPU
    context (the tests run without a card)."""

    @staticmethod
    def Context(nb_cores=1):
        return Context(nb_cores=nb_cores, device="cpu")


# --------------------------------------------------------------- the model
def test_shape_bucket_stability():
    """Log4 buckets: sizes within 4x share a regime, monotone, and
    degenerate sizes key stably at 0."""
    assert shape_bucket(0) == 0 and shape_bucket(-8) == 0
    assert shape_bucket(1) == 0 and shape_bucket(3) == 0
    assert shape_bucket(4) == shape_bucket(15)
    assert shape_bucket(16) == shape_bucket(63) == shape_bucket(4) + 1
    last = 0
    for nbytes in [1, 7, 64, 4096, 1 << 20, 1 << 30]:
        b = shape_bucket(nbytes)
        assert b >= last
        last = b


def test_ewma_tracks_regime_change():
    """The EWMA converges on a stable cost, then follows the workload into
    a new regime instead of averaging the two forever (within 5%, the
    reference's tolerance)."""
    m = CostModel()
    for _ in range(16):
        m.observe("k", 0, "cpu", 100.0)
    assert m.measured("k", 0, "cpu")
    assert m.cost("k", 0, "cpu") == pytest.approx(100.0, rel=0.05)
    for _ in range(32):
        m.observe("k", 0, "cpu", 1000.0)
    assert m.cost("k", 0, "cpu") == pytest.approx(1000.0, rel=0.05)
    # weighted folds converge like the many small folds they stand for
    m2 = CostModel()
    m2.observe("k", 0, "cpu", 100.0, n=16)
    m2.observe("k", 0, "cpu", 1000.0, n=500)
    assert m2.cost("k", 0, "cpu") == pytest.approx(1000.0, rel=0.05)


def test_cold_start_prior_fallback():
    """An unmeasured key answers its seeded prior (the time_estimate hook's
    slot); measurements override it as the key warms up."""
    m = CostModel()
    assert m.cost("p", 2, "cuda") is None
    m.seed_prior("p", 2, "cuda", 5000.0)
    assert not m.measured("p", 2, "cuda")
    assert m.cost("p", 2, "cuda") == 5000.0
    for _ in range(int(mca.get("costmodel_min_count", 8))):
        m.observe("p", 2, "cuda", 80.0)
    assert m.measured("p", 2, "cuda")
    assert m.cost("p", 2, "cuda") == pytest.approx(80.0, rel=0.05)


def test_nearest_bucket_answers_neighbor():
    """A measured neighbour bucket answers for a cold one — and the EXACT
    bucket's measurement wins once it exists."""
    m = CostModel()
    for _ in range(8):
        m.observe("n", 3, "cpu", 700.0)
    assert m.cost("n", 4, "cpu") == pytest.approx(700.0, rel=0.05)
    assert not m.measured("n", 4, "cpu")
    for _ in range(8):
        m.observe("n", 4, "cpu", 90.0)
    assert m.cost("n", 4, "cpu") == pytest.approx(90.0, rel=0.05)


def test_explore_ticket_is_one_shot():
    m = CostModel()
    assert m.begin_explore("e", 0, "cuda")
    assert not m.begin_explore("e", 0, "cuda")
    assert m.begin_explore("e", 1, "cuda")   # a different key explores


def test_persistence_roundtrip_and_stale_fingerprint(tmp_path):
    """Save → load restores the learned entries when the device fingerprint
    matches; a stale fingerprint discards the file rather than mis-place on
    other hardware."""
    path = str(tmp_path / "cost.json")
    mca.set("costmodel_persist", path)
    try:
        m = CostModel()
        for _ in range(10):
            m.observe("r", 1, "cpu", 250.0)
        m.seed_prior("r", 1, "cuda", 9000.0)
        snap = COSTMODEL_STATS.snapshot()
        m.maybe_save()
        assert COSTMODEL_STATS.delta(snap)["persist_saves"] == 1

        m2 = CostModel()
        m2.maybe_load()
        assert m2.measured("r", 1, "cpu")
        assert m2.cost("r", 1, "cpu") == pytest.approx(250.0, rel=0.05)
        assert m2.cost("r", 1, "cuda") == 9000.0
        assert COSTMODEL_STATS.delta(snap)["persist_loads"] == 1

        # corrupt the fingerprint: the load must leave the model cold
        with open(path, "r", encoding="utf-8") as f:
            blob = json.load(f)
        blob["fingerprint"] = ["bogus-device"]
        with open(path, "w", encoding="utf-8") as f:
            json.dump(blob, f)
        m3 = CostModel()
        m3.maybe_load()
        assert m3.cost("r", 1, "cpu") is None
        assert COSTMODEL_STATS.delta(snap)["persist_stale"] == 1
    finally:
        mca.params.unset("costmodel_persist")


# ------------------------------------------------------- feeding discipline
def _mk(name, nt=4):
    A = TiledMatrix(name, 1, nt, 1, 1)
    A.fill(lambda m, n: np.zeros((1, 1), np.float32))
    return A


_CHAIN_SRC = """
%global NT
%global descA

T(k)
  k = 0 .. NT-1
  : descA(0, k)
  RW X <- descA(0, k)
       -> descA(0, k)
BODY
  X = X + 1.0
END
"""


def test_fold_on_detach_exact_counts():
    """The C cost rows fold into the model when the lane graph finishes,
    with EXACT task counts — every executed task lands in its class's
    accumulator."""
    NT = 12
    mca.set("region_fusion", False)     # unfused rows: one task, one bump
    ctx = pt.Context(nb_cores=1)
    try:
        A = _mk("descA", NT)
        tp = compile_ptg(_CHAIN_SRC, "cmfold").instantiate(
            ctx, globals={"NT": NT}, collections={"descA": A})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        assert tp._ptexec_state is not None, "lane should have engaged"
    finally:
        ctx.fini()
        mca.params.unset("region_fusion")
    key = ("cmfold.T", tp._ptexec_pool_bucket(), "cpu")
    assert costmodel.model.count(*key) == NT
    assert costmodel.model.cost(*key) is not None
    assert costmodel.model.cost(*key) > 0


def test_fold_is_idempotent_per_lane():
    """A lane folds once: a second context over the same program does not
    double-fold the first lane's rows."""
    NT = 6
    mca.set("region_fusion", False)
    try:
        prog = compile_ptg(_CHAIN_SRC, "cmonce")
        counts = []
        for _ in range(2):
            ctx = pt.Context(nb_cores=1)
            try:
                A = _mk("descA", NT)
                tp = prog.instantiate(ctx, globals={"NT": NT},
                                      collections={"descA": A})
                ctx.add_taskpool(tp)
                ctx.wait(timeout=60)
            finally:
                ctx.fini()
            counts.append(costmodel.model.count(
                "cmonce.T", tp._ptexec_pool_bucket(), "cpu"))
    finally:
        mca.params.unset("region_fusion")
    assert counts == [NT, 2 * NT]


# --------------------------------------------------- consumer (a) placement
_DEV_SRC = """
%global NT
%global descA

T(k)
  k = 0 .. NT-1
  : descA(0, k)
  RW X <- descA(0, k)
       -> descA(0, k)
BODY [type=CUDA]
  X = X + 1.0
END
"""


def _run_dev_pool(prog_name, src=_DEV_SRC, globals_=None, nt=4):
    mca.set("device_cuda_over_cpu", True)
    ctx = pt.Context(nb_cores=1)
    try:
        A = _mk("descA", nt)
        g = {"NT": nt}
        g.update(globals_ or {})
        tp = compile_ptg(src, prog_name).instantiate(
            ctx, globals=g, collections={"descA": A})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        return A, tp._ptexec_state, tp._ptexec_pool_bucket()
    finally:
        ctx.fini()
        mca.params.unset("device_cuda_over_cpu")


def test_placement_diverges_to_cpu_and_skips_dev_lane():
    """A CUDA-bodied class MEASURED cheaper on its CPU twin is placed on
    the CPU (diverging from the static has-a-device-body heuristic) and a
    pool with no device-placed class skips the ptdev lane entirely."""
    m = costmodel.model
    bucket = shape_bucket(4)            # 1x1 f32 tiles
    m.observe("cmplace.T", bucket, "cpu", 1_000.0, n=16)
    m.observe("cmplace.T", bucket, "cuda", 50_000_000.0, n=16)
    snap = COSTMODEL_STATS.snapshot()
    A, state, _ = _run_dev_pool("cmplace")
    d = COSTMODEL_STATS.delta(snap)
    np.testing.assert_array_equal(
        np.asarray(A.data_of(0, 0).newest_copy().payload),
        np.ones((1, 1), np.float32))
    assert state is not None
    assert state.get("dev_pool") is None, \
        "CPU-placed pool must not bind the device lane"
    assert d["placements_adaptive"] >= 1
    assert d["placements_diverged"] >= 1
    assert d["decisions"] >= 1 and d["decision_ns"] > 0


def test_placement_keeps_tpu_when_measured_cheaper():
    """The device flavour measured cheaper keeps the class on the device
    lane (the reference's ``tpu`` key is ``cuda`` here)."""
    m = costmodel.model
    bucket = shape_bucket(4)
    m.observe("cmkeep.T", bucket, "cpu", 50_000_000.0, n=16)
    m.observe("cmkeep.T", bucket, "cuda", 1_000.0, n=16)
    snap = COSTMODEL_STATS.snapshot()
    _, state, _ = _run_dev_pool("cmkeep")
    assert state is not None and state.get("dev_pool") is not None
    assert COSTMODEL_STATS.delta(snap)["placements_diverged"] == 0


def test_time_estimate_seeds_prior_not_decline():
    """A device class with a user ``time_estimate`` hook rides the native
    lane (no pools_ineligible), and the hook's answers land as the model's
    cold-start priors."""
    from parsec_tpu_torch.device.native import PTDEV_STATS
    calls = []

    def est(task, device):
        calls.append(type(device).__name__)
        return 0.25

    src = _DEV_SRC.replace("%global descA",
                           "%global descA\n%global my_est").replace(
        "T(k)", "T(k) [ time_estimate = my_est ]")
    snap = PTEXEC_STATS.snapshot()
    dsnap = PTDEV_STATS.snapshot()
    csnap = COSTMODEL_STATS.snapshot()
    A, state, bucket = _run_dev_pool("cmprior", src=src,
                                     globals_={"my_est": est})
    np.testing.assert_array_equal(
        np.asarray(A.data_of(0, 0).newest_copy().payload),
        np.ones((1, 1), np.float32))
    assert state is not None, "time_estimate must not decline the lane"
    assert PTEXEC_STATS.delta(snap)["pools_engaged"] >= 1
    assert PTEXEC_STATS.delta(snap)["pools_fallback"] == 0
    assert PTDEV_STATS.delta(dsnap)["pools_ineligible"] == 0
    assert COSTMODEL_STATS.delta(csnap)["priors_seeded"] >= 1
    assert calls, "the hook must be consulted (as the cold-start prior)"
    # the hook's answer (0.25 s) is the class's prior until measured
    prior = costmodel.model.snapshot().get(("cmprior.T", bucket, "cpu"))
    assert prior is not None and prior[2] == pytest.approx(0.25e9)


# ----------------------------------------------- consumer (b) fusion sizing
def test_fusion_declines_measured_slower_class():
    """A class whose measured fused per-task cost meets/exceeds its unfused
    cost is un-fused; a class measured faster fused stays."""
    from parsec_tpu_torch.dsl.fusion import adaptive_fusion_limits
    m = costmodel.model
    m.observe("slow", 0, "cpu", 1_000.0, n=16)
    m.observe("slow", 0, "cpu_fused", 2_000.0, n=16)
    m.observe("fast", 0, "cpu", 2_000.0, n=16)
    m.observe("fast", 0, "cpu_fused", 100.0, n=16)
    snap = COSTMODEL_STATS.snapshot()
    declined, _, _ = adaptive_fusion_limits(
        [("slow", 0, "cpu"), ("fast", 0, "cpu")])
    d = COSTMODEL_STATS.delta(snap)
    assert declined == {0}
    assert d["fusion_declined"] == 1 and d["fusion_sized"] == 1


def test_fusion_cap_shrinks_to_measured_break_even():
    """A measured per-member first-call cost far above the per-task
    dispatch saving splits regions down to the static minimum; with the
    model cold the static knobs rule."""
    from parsec_tpu_torch.dsl.fusion import adaptive_fusion_limits
    static_min = int(mca.get("region_fusion_min", 2))
    static_max = int(mca.get("region_fusion_max", 128))
    declined, mn, mx = adaptive_fusion_limits([("cold", 0, "cpu")])
    assert (declined, mn, mx) == (set(), static_min, static_max)
    m = costmodel.model
    m.observe("hot", 0, "cpu", 1_000.0, n=16)
    # first-call cost measured at EVERY band, per-member cost shrinking
    # with region size but always above the saving: the cap walks down to
    # the static minimum
    size = static_min
    while size <= static_max:
        for _ in range(8):
            m.note_region_trace("cpu", size, size * size * 10**6)
        size *= 2
    declined, mn, mx = adaptive_fusion_limits([("hot", 0, "cpu")])
    assert declined == set()
    assert mn == static_min and mx == static_min
    # an UNMEASURED smaller band stops the walk: splitting is never
    # speculative
    m.reset()
    m.observe("hot2", 0, "cpu", 1_000.0, n=16)
    for _ in range(8):
        m.note_region_trace("cpu", static_max, static_max * 10**9)
    declined, mn, mx = adaptive_fusion_limits([("hot2", 0, "cpu")])
    assert mx == static_max


def test_fusion_limits_disabled_by_knob():
    from parsec_tpu_torch.dsl.fusion import adaptive_fusion_limits
    m = costmodel.model
    m.observe("k", 0, "cpu", 1_000.0, n=16)
    m.observe("k", 0, "cpu_fused", 9_000.0, n=16)
    mca.set("costmodel_fusion", False)
    try:
        declined, mn, mx = adaptive_fusion_limits([("k", 0, "cpu")])
        assert declined == set()
        assert mx == int(mca.get("region_fusion_max", 128))
    finally:
        mca.params.unset("costmodel_fusion")


# ------------------------------------------- cross-check: both packages
#: one sequence of observations: (class, bucket, device key, mean ns, n),
#: device keys in the port's spelling
_OBS = [("x.A", 0, "cpu", 1_000.0, 16), ("x.A", 0, "cuda", 9_000.0, 16),
        ("x.B", 0, "cpu", 7_000.0, 16), ("x.B", 0, "cuda", 300.0, 16),
        ("x.C", 0, "cuda", 800.0, 16),
        ("x.D", 0, "cpu", 500.0, 3), ("x.D", 0, "cuda", 400.0, 3),
        ("x.A", 0, "cpu", 1_200.0, 5), ("__stage_in__", 0, "cuda", 50.0, 9)]


def _ref_dev(key: str) -> str:
    return key.replace("cuda", "tpu")


def _placements(m, stage_in_key: str, dev_key: str, classes):
    """The decision ladder of ``_ptexec_place_classes`` over ``m`` for
    classes that all have a device body (no priors seeded)."""
    out = []
    for name in classes:
        cpu_known = m.measured(name, 0, "cpu")
        dev_known = m.measured(name, 0, dev_key)
        if cpu_known and dev_known:
            dev_ns = m.cost(name, 0, dev_key)
            st = m.cost(stage_in_key, 0, dev_key)
            if st is not None:
                dev_ns += st * min(1.0, m.count(stage_in_key, 0, dev_key)
                                   / max(1, m.count(name, 0, dev_key)))
            out.append(dev_ns <= m.cost(name, 0, "cpu"))
        elif dev_known:
            out.append(not m.begin_explore(name, 0, "cpu"))
        elif cpu_known:
            out.append(m.begin_explore(name, 0, dev_key))
        else:
            out.append(True)
    return out


def test_cross_check_same_observations_same_placements(tmp_path):
    """One sequence of observations fed to the reference's model and to the
    port's gives the same placements (the port's ladder run through
    ``_ptexec_place_classes`` on a real pool and the same ladder over the
    reference's model), the same costs (exactly: the EWMA arithmetic is
    identical) and the same persisted entries, with ``tpu`` read as
    ``cuda``."""
    from parsec_tpu.core import costmodel as ref_cm
    from parsec_tpu.utils import mca as ref_mca
    ref = ref_cm.CostModel()
    port = CostModel()
    for cls, b, dev, ns, n in _OBS:
        port.observe(cls, b, dev, ns, n)
        ref.observe(cls, b, _ref_dev(dev), ns, n)
    names = ["x.A", "x.B", "x.C", "x.D"]
    for cls in names:
        for dev in ("cpu", "cuda"):
            assert port.cost(cls, 0, dev) == ref.cost(cls, 0, _ref_dev(dev))
            assert port.measured(cls, 0, dev) == \
                ref.measured(cls, 0, _ref_dev(dev))
    want = _placements(ref, ref_cm.STAGE_IN, "tpu", names)
    assert want == [False, True, False, True]
    assert _placements(port, costmodel.STAGE_IN, "cuda", names) == want
    # the port's placement consumer itself, over the process model
    for cls, b, dev, ns, n in _OBS:
        costmodel.model.observe(cls, b, dev, ns, n)
    prog = compile_ptg(_DEV_SRC, "x")
    mca.set("device_cuda_over_cpu", True)
    ctx = pt.Context(nb_cores=1)
    try:
        tp = prog.instantiate(ctx, globals={"NT": 1},
                              collections={"descA": _mk("descA", 1)})
        tc = tp._classes["T"]
        got = [tp._ptexec_place_classes([tc], [True], (name,), 0)[0]
               for name in names]
    finally:
        ctx.fini()
        mca.params.unset("device_cuda_over_cpu")
    assert got == want
    # persisted entries: identical up to the device key's name
    rpath, ppath = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    ref_mca.set("costmodel_persist", rpath)
    mca.set("costmodel_persist", ppath)
    try:
        ref.maybe_save()
        port.maybe_save()
    finally:
        ref_mca.params.unset("costmodel_persist")
        mca.params.unset("costmodel_persist")
    with open(rpath, encoding="utf-8") as f:
        rblob = json.load(f)
    with open(ppath, encoding="utf-8") as f:
        pblob = json.load(f)
    assert rblob["version"] == pblob["version"]
    assert sorted([c, b, _ref_dev(d), e, n, p]
                  for c, b, d, e, n, p in pblob["entries"]) == \
        sorted(rblob["entries"])


# ------------------------------------------ consumer (c): reconciler gain
class _StubFabric:
    nb_ranks = 1
    my_rank = 0
    rde = None
    _dead: set = set()

    def __init__(self):
        self.weights = {}

    def set_weight(self, t, w):
        self.weights[t] = w


def _stepped_reconciler(monkeypatch, errs, package="parsec_tpu_torch"):
    """A reconciler (of ``package``) whose scrape yields windows with the
    given max share errors (two tenants, weights 1:1 — tenant 'b'
    under-serves)."""
    import importlib
    reconcile = importlib.import_module(f"{package}.serving.reconcile")
    rec = reconcile.ShareReconciler(_StubFabric(), [], {"a": 1.0, "b": 1.0})
    served = {"a": 0, "b": 0}
    feed = iter(errs)

    def scrape():
        try:
            err = next(feed)
        except StopIteration:
            return None
        # share error e% with two 1:1 tenants: a gets (50+e/2)% of 1000
        n_a = int(1000 * (0.5 + err / 200.0))
        served["a"] += n_a
        served["b"] += 1000 - n_a
        return {0: dict(served)}, set()     # one rank, none missing

    monkeypatch.setattr(rec, "_scrape", scrape)
    rec.step()                  # baseline window (no delta yet)
    return rec


def test_reconciler_gain_damps_on_overshoot(monkeypatch):
    rec = _stepped_reconciler(monkeypatch, [10.0, 10.0, 30.0])
    snap = COSTMODEL_STATS.snapshot()
    assert rec.step() == pytest.approx(10.0, abs=0.5)
    g0 = rec.gain
    assert rec.step() == pytest.approx(30.0, abs=0.5)  # error GREW
    assert rec.gain < g0
    assert COSTMODEL_STATS.delta(snap)["gain_adapted"] >= 1


def test_reconciler_gain_boosts_on_stall(monkeypatch):
    rec = _stepped_reconciler(monkeypatch, [40.0, 40.0, 38.0])
    rec.step()
    g0 = rec.gain
    rec.step()                  # error large and barely shrinking
    assert rec.gain > g0
    assert rec.gain <= 1.5


def test_reconciler_gain_frozen_by_knob(monkeypatch):
    mca.set("costmodel_reconcile", False)
    try:
        rec = _stepped_reconciler(monkeypatch, [10.0, 10.0, 30.0])
        rec.step()
        g0 = rec.gain
        rec.step()
        assert rec.gain == g0
    finally:
        mca.params.unset("costmodel_reconcile")


@pytest.mark.parametrize("errs", [[10.0, 10.0, 30.0, 12.0, 4.0],
                                  [40.0, 40.0, 38.0, 37.0, 36.0, 20.0]])
@pytest.mark.parametrize("adapt", [True, False])
def test_reconciler_gain_matches_the_reference(monkeypatch, errs, adapt):
    """One sequence of share errors through both packages' reconcilers,
    with the gain's consumer on and off: the same error, gain and weights
    every round."""
    from parsec_tpu.utils import mca as ref_mca
    mca.set("costmodel_reconcile", adapt)
    ref_mca.set("costmodel_reconcile", adapt)
    try:
        port = _stepped_reconciler(monkeypatch, errs)
        ref = _stepped_reconciler(monkeypatch, errs, "parsec_tpu")
        trail = []
        for _ in errs:
            e_port, e_ref = port.step(), ref.step()
            assert e_port == e_ref
            assert port.gain == ref.gain
            assert port.fabric.weights == ref.fabric.weights
            trail.append(port.gain)
        assert (len(set(trail)) > 1) == adapt
    finally:
        mca.params.unset("costmodel_reconcile")
        ref_mca.params.unset("costmodel_reconcile")
