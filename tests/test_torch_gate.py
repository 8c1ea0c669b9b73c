"""chip_smoke.py's correctness rules, on the CPU: the serving comparison of the
whole-path gate (serving_rule, gate_spread and its no-kernel controls) and the
card's RANSAC rule (ransac_rule).

The rules run on the card; here their pure-numpy parts are held on made-up
deviations and spreads, each beside a planted fault that must fail, and the
controls and the planted LM fault are run on small CPU inputs: the tiny network
at random weights (torch.manual_seed), float32 (bf16 convolutions are slow on the
CPU), two 64×64 rendered views, and exact fields from the port's own geometry.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke as smoke
import geocalib_tpu_torch
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.geometry.perspective_fields import get_perspective_field
from geocalib_tpu_torch.ops import lm_system as lm_ops, nmf as nmf_ops
from geocalib_tpu_torch.optim import lm as lm_solver
from geocalib_tpu_torch.optim.lm import LMConfig

TOL, FLOOR, FACTOR = smoke.ANGLE_TOL, smoke.GATE_FLOOR_DEG, smoke.GATE_SPREAD_FACTOR


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lanes(n, spread=1e-4, dev=0.0):
    return np.full((n, 3), dev), np.full((n, 3), spread), np.ones(n, bool)


def test_serving_rule_holds_each_lane_to_its_spread():
    dev, spread, judged = _lanes(4)
    spread[1] = [2e-3, 2e-4, 1e-2]  # 4 s: 8e-3, 8e-4 (under the floor), 4e-2
    dev[1] = [7.9e-3, 9.9e-4, 3.9e-2]
    rule = smoke.serving_rule(dev, spread, judged)
    np.testing.assert_allclose(rule["tol"][0], [FLOOR] * 3)
    np.testing.assert_allclose(rule["tol"][1], [8e-3, FLOOR, 4e-2])
    assert rule["ok"] and not rule["ill"].any() and not rule["fail"].any()


@pytest.mark.parametrize("angle", [0, 1, 2])
def test_serving_rule_fails_a_planted_fault(angle):
    """A lane moved past 4 s in one angle fails, though it stays well within the flat
    0.05 degrees of the old rule; the same lane stopping apart is not judged."""
    dev, spread, judged = _lanes(8, spread=1e-3)
    dev[3, angle] = 4.1e-3
    rule = smoke.serving_rule(dev, spread, judged)
    assert not rule["ok"] and rule["fail"].tolist() == [i == 3 for i in range(8)]
    judged[3] = False
    assert smoke.serving_rule(dev, spread, judged)["ok"]


def test_serving_rule_names_an_ill_conditioned_lane():
    """A lane whose 4 s exceeds 0.05 degrees is held to 4 s and named; one in four
    lanes may be."""
    dev, spread, judged = _lanes(4)
    spread[0, 2] = 0.0553  # request e's lane 0: a float64 NMF moved its vFoV this far
    dev[0, 2] = 0.06
    rule = smoke.serving_rule(dev, spread, judged)
    assert rule["ill"].tolist() == [True, False, False, False]
    assert rule["tol"][0, 2] == pytest.approx(4 * 0.0553) and rule["ok"]
    dev[0, 2] = 0.23  # past its 4 s
    assert not smoke.serving_rule(dev, spread, judged)["ok"]


@pytest.mark.parametrize("angle", [0, 1, 2])
@pytest.mark.parametrize("lanes, ill, ok", [(1, 1, True), (4, 1, True), (8, 1, True),
                                            (8, 2, False), (16, 2, True), (16, 3, False)])
def test_serving_rule_allows_one_ill_lane_in_eight(lanes, ill, ok, angle):
    """At most one lane in eight, rounded up, held past 0.05 degrees: with more named
    ill-conditioned, none is, so a lane 0.06 degrees off within its 4 s = 0.08 fails,
    and is left open (the rule cannot settle it)."""
    dev, spread, judged = _lanes(lanes)
    spread[:ill, angle] = 0.02
    dev[:ill, angle] = 0.06
    rule = smoke.serving_rule(dev, spread, judged)
    assert int(rule["ill"].sum()) == ill and rule["ok"] == ok and rule["capped"] != ok
    assert rule["open"].tolist() == [i < ill and not ok for i in range(lanes)]
    assert rule["tol"][:ill, angle] == pytest.approx(0.08 if ok else TOL)


def test_serving_rule_refuses_to_widen_past_the_cap():
    """vFoV ill-conditioned in every lane (a flat focal): each lane named, none held
    past 0.05 degrees. A lane within 0.05 passes; one past 0.05 but within its 4 s
    fails and is open; past its 4 s, or past a bound the cap did not touch, it fails
    and is not."""
    dev, spread, judged = _lanes(16)
    spread[:, 2] = 0.03
    dev[:, 2] = 0.04
    rule = smoke.serving_rule(dev, spread, judged)
    assert rule["ill"].all() and rule["capped"] and rule["ok"]
    np.testing.assert_allclose(rule["tol"][:, 2], TOL)
    dev[3, 2], dev[5, 2], dev[7, 0] = 0.11, 0.121, 4.1e-4 * FACTOR
    rule = smoke.serving_rule(dev, spread, judged)
    assert np.flatnonzero(rule["fail"]).tolist() == [3, 5, 7]
    assert np.flatnonzero(rule["open"]).tolist() == [3] and not rule["ok"]


def _hypotheses(n=400, seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-1.0, 1.0, n)
    ulp = np.abs(ref) * 10.0 ** rng.uniform(-7.5, -6.0, n)
    ulp[:3] = np.abs(ref[:3]) * [3e-5, 1e-3, 2e-2]  # three ill-conditioned samples
    return ref, ulp


def test_ransac_rule_bounds_well_and_ill_conditioned_hypotheses():
    ref, ulp = _hypotheses()
    hyp = ref * (1 + 0.9e-5)
    hyp[:3] = ref[:3] + 3.9 * ulp[:3]
    rule = smoke.ransac_rule(hyp, ref, ulp, ulp, 0.01)
    assert rule["ok"] and rule["ill"].sum() == 3 and rule["apart_share"] == 3 / len(ref)
    assert rule["ill_share"] == 3 / len(ref)


@pytest.mark.parametrize("fault", ["well-conditioned", "ill-conditioned", "share"])
def test_ransac_rule_fails_a_planted_fault(fault):
    """A well-conditioned hypothesis 2e-5 off, an ill-conditioned one 5 spreads off (the
    old rule had no bound there), or more apart than the ceiling allows."""
    ref, ulp = _hypotheses()
    hyp = ref.copy()
    if fault == "well-conditioned":
        hyp[10] = ref[10] * (1 + 2e-5)
    elif fault == "ill-conditioned":
        hyp[1] = ref[1] + 5 * ulp[1]
    else:
        hyp[:3] = ref[:3] + ulp[:3]
    share = 2 / len(ref) if fault == "share" else 0.01
    assert not smoke.ransac_rule(hyp, ref, ulp, ulp, share)["ok"]


def test_nmf_control_without_a_change_is_nmf_plain():
    """The NMF controls change one thing each: with none, nmf_plain's bits (and with
    float32 products from the library, as nmf_plain takes them); in chunks of tokens
    or in float64, a deviation at float32's rounding."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 300, 24, generator=g)
    bases = torch.rand(2, 24, 6, generator=g)
    plain = torch.matmul(*nmf_ops.nmf_plain(x, bases))
    assert torch.equal(torch.matmul(*smoke.nmf_control(x, bases)), plain)
    assert torch.equal(torch.matmul(*smoke.nmf_control(x, bases, native=True)), plain)
    for kw in ({"chunks": 2}, {"chunks": 4}, {"wide": True}):
        dev = float((torch.matmul(*smoke.nmf_control(x, bases, **kw)) - plain).abs().max())
        assert 0.0 < dev <= 1e-5 * float(plain.abs().max()), (kw, dev)


def test_plain_lm_in_another_order_sums_the_same_terms():
    """The LM controls over pixels in another order: G, H and the cost of the plain
    system within float32's summation error, and not its bits."""
    g = torch.Generator().manual_seed(0)
    B, h, w = 2, 48, 64
    obs = {k: torch.rand(B, h * w, generator=g) for k in lm_ops.OBS_KEYS}
    cam = Camera.from_dict({"height": torch.full((B,), float(h)),
                            "width": torch.full((B,), float(w)), "vfov": torch.tensor([0.9, 1.1])})
    grav = Gravity.from_rp(torch.tensor([0.1, -0.2]), torch.tensor([0.05, 0.3]))
    ref = lm_ops.lm_system_plain(obs, cam, grav, h, w, LMConfig())
    moved = False
    for order in ("reversed", "rotated"):
        got = smoke._lm_plain_in_order(order)(obs, cam, grav, h, w, LMConfig())
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
            moved |= not torch.equal(a, b)
    assert moved


def test_planted_lm_fault_moves_the_fixed_point_by_its_size():
    """shifted_lm's G + H v: the converged gravity moves by |v| = sqrt(2) x 0.02 degrees,
    on exact fields of two cameras."""
    B, h, w = 2, 48, 64
    cam = Camera.from_dict({"height": torch.full((B,), float(h)),
                            "width": torch.full((B,), float(w)), "vfov": torch.tensor([0.9, 1.2])})
    grav = Gravity.from_rp(torch.tensor([0.2, -0.1]), torch.tensor([0.1, 0.3]))
    up, lat = get_perspective_field(cam, grav, h, w)
    data = {"up_field": up, "latitude_field": lat}
    cfg = LMConfig(early_stop=False)
    ref = lm_solver.run_lm(data, cfg).gravity.vec3d
    with smoke.shifted_lm():
        got = lm_solver.run_lm(data, cfg).gravity.vec3d
    angle = torch.rad2deg(torch.arccos(torch.clamp((ref * got).sum(-1) / (
        ref.norm(dim=-1) * got.norm(dim=-1)), -1, 1)).double())
    np.testing.assert_allclose(angle.numpy(), math.sqrt(2) * smoke.GATE_LM_SHIFT_DEG, rtol=0.1)


def test_gate_spread_on_a_tiny_cpu_run():
    """The plain path served twice more under two controls: the spread is nonzero, and in
    a well-conditioned lane below the floor, so the plain route's own rerun passes."""
    torch.manual_seed(0)
    cal = geocalib_tpu_torch.GeoCalib(device="cpu", variant="tiny", compute_dtype="float32")
    images, _ = smoke.scenes(np.random.default_rng(0), 2, 64, 64)
    requests = {"a": (cal, images, {"batched": True})}
    with smoke.plain_versions():
        ref = smoke.gate_serve(requests, ("serving",))["serving"]
    spread = smoke.gate_spread(requests, ref, ("plain NMF, sums in float64",
                                               "plain LM, G x (1 + 2^-22)"))["a"]["spread"]
    assert spread.shape == (2, 3) and spread.max() > 0.0
    rule = smoke.serving_rule(np.zeros_like(spread), spread, np.ones(2, bool))
    assert rule["ok"] and (spread * FACTOR < FLOOR).all() and not rule["ill"].any()
