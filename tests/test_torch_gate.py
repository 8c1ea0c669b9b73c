"""chip_smoke.py's correctness rules, on the CPU: the serving comparison of the
whole-path gate (serving_rule, gate_spread and its no-kernel controls) and the
card's RANSAC rule (ransac_rule).

The rules run on the card; here their pure-numpy parts are held on made-up
deviations and spreads, each beside a planted fault that must fail, and the
controls and the planted LM faults are run on small CPU inputs: the tiny network
at random weights (torch.manual_seed), float32 (bf16 convolutions are slow on the
CPU), two 64×64 rendered views, and exact fields from the port's own geometry.
The panorama views of requests g and h (pano_views) are rendered here from small
panoramas of the gate's seeds, and tools/lm_state_trace.py's readings are taken on
a tiny training step.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as smoke
import geocalib_tpu_torch
from geocalib_tpu_torch.data import generate as gen_lib, pano as pano_lib
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


def _exact_fields(model, k1=0.0):
    B, h, w = 2, 48, 64
    cam = Camera.from_dict({"height": torch.full((B,), float(h)),
                            "width": torch.full((B,), float(w)), "vfov": torch.tensor([0.9, 1.2]),
                            "k1": torch.full((B,), k1)}, model=model)
    grav = Gravity.from_rp(torch.tensor([0.2, -0.1]), torch.tensor([0.1, 0.3]))
    up, lat = get_perspective_field(cam, grav, h, w)
    return {"up_field": up, "latitude_field": lat}


@pytest.mark.parametrize("model, k1", [("pinhole", 0.0), ("simple_divisional", smoke.DIVISION_K1)])
def test_planted_vfov_fault_moves_the_fixed_point_by_its_size(model, k1):
    """shifted_lm(focal=True)'s G + H v, v in the focal alone: the converged vFoV moves by
    0.02 degrees and the gravity stays, on exact fields of two cameras, pinhole and
    through request h's lens."""
    data = _exact_fields(model, k1)
    cfg = LMConfig(camera_model=model, early_stop=False)
    ref = lm_solver.run_lm(data, cfg)
    with smoke.shifted_lm(focal=True):
        got = lm_solver.run_lm(data, cfg)
    vfov = torch.rad2deg((got.camera.vfov - ref.camera.vfov).abs().double())
    np.testing.assert_allclose(vfov.numpy(), smoke.GATE_LM_SHIFT_DEG, rtol=0.1)
    a, b = ref.gravity.vec3d.double(), got.gravity.vec3d.double()
    angle = torch.rad2deg(torch.arccos(torch.clamp((a * b).sum(-1) / (a.norm(dim=-1)
                                                                     * b.norm(dim=-1)), -1, 1)))
    assert float(angle.max()) < 0.05 * smoke.GATE_LM_SHIFT_DEG


def _small_panos():
    return [pano_lib.synthetic_pano(s, 64, 128) for s in smoke.GATE_PANO_SEEDS]


def test_gate_pano_seeds_are_streets_and_rooms():
    """Each seed's first draw selects _city_pano (r < 0.40) or _room_pano (r < 0.65),
    and both families are there; a panorama pixel is no coarser than a 480-row crop's
    at the centre at vFoV 1.3 rad."""
    draws = [np.random.default_rng(s).random() for s in smoke.GATE_PANO_SEEDS]
    assert all(r < 0.65 for r in draws)
    assert any(r < 0.40 for r in draws) and any(0.40 <= r < 0.65 for r in draws)
    Hp, Wp = smoke.GATE_PANO_SIZE
    assert Wp == 2 * Hp and math.pi / (Hp - 1) <= math.tan(0.65) / 240


def test_gate_panos_are_the_serial_panoramas(monkeypatch):
    """The host threads give each seed's panorama bit for bit."""
    monkeypatch.setattr(smoke, "GATE_PANO_SIZE", (64, 128))
    panos, seconds = smoke.gate_panos()
    assert seconds >= 0.0 and len(panos) == len(smoke.GATE_PANO_SEEDS)
    assert all(np.array_equal(a, b) for a, b in zip(panos, _small_panos()))


@pytest.mark.parametrize("k1", [0.0, smoke.DIVISION_K1])
def test_pano_views_repeat_bit_for_bit(k1):
    """The same seeds give the same crops, bit for bit, and other crop seeds others."""
    views = [smoke.pano_views(_small_panos(), np.random.default_rng(11), 6, 24, 32, k1=k1,
                              device="cpu") for _ in range(2)]
    assert np.array_equal(views[0][0], views[1][0]) and views[0][1] == views[1][1]
    assert views[0][0].shape == (6, 24, 32, 3) and views[0][0].dtype == np.float32
    assert np.isfinite(views[0][0]).all() and 0.0 <= views[0][0].min() <= views[0][0].max() <= 1.0
    other = smoke.pano_views(_small_panos(), np.random.default_rng(12), 6, 24, 32, k1=k1,
                             device="cpu")
    assert not np.array_equal(views[0][0], other[0])


@pytest.mark.parametrize("k1", [0.0, smoke.DIVISION_K1])
def test_pano_views_truth_is_the_drawn_camera(k1):
    """The truth is the drawn roll, pitch and vFoV, and each crop is its panorama
    rendered by the drawn camera (roll, pitch, vFoV, yaw; k1) alone."""
    panos = _small_panos()
    images, truth = smoke.pano_views(panos, np.random.default_rng(11), 6, 24, 32, k1=k1,
                                     device="cpu")
    rng = np.random.default_rng(11)
    model = "simple_divisional" if k1 else "pinhole"
    for i in range(6):
        roll, pitch = rng.uniform(-0.3, 0.3, 2)
        vfov, yaw = rng.uniform(0.7, 1.3), rng.uniform(0.0, 2 * math.pi)
        assert truth[i] == [math.degrees(roll), math.degrees(pitch), math.degrees(vfov)]
        row = {"height": 24, "width": 32, "roll": roll, "pitch": pitch, "vfov": vfov, "k1": k1}
        cam, grav, yaw_t = gen_lib.row_views([row], np.array([yaw], np.float32), model, "cpu")
        crop = pano_lib.render_from_pano(torch.from_numpy(panos[i % len(panos)]), cam, grav, yaw_t)
        assert np.array_equal(crop[0].numpy(), images[i])
        assert cam.k[0, 0] == np.float32(k1)


def _tiny_step():
    """One compute_grads of the tiny network at random weights, float32, on two 64x64
    rendered views (a closure over its state, batch and key)."""
    from geocalib_tpu_torch.training import train_step as train_lib
    cfg = train_lib.TrainConfig(variant="tiny", lm_steps=4, drop_path_rate=0.0,
                                compute_dtype="float32")
    torch.manual_seed(0)
    net, state = train_lib.create_train_state(cfg, None, device="cpu")
    images, truth = smoke.scenes(np.random.default_rng(0), 2, 64, 64)
    gt = [[64.0, 64.0, math.radians(f), math.radians(r), math.radians(p), 0.0, 0.0]
          for r, p, f in truth]
    batch = {"image": torch.from_numpy(images), "gt_params": torch.tensor(gt)}
    return lambda: train_lib.compute_grads(net, cfg, state, batch, (0, 5))


def _trace_tool():
    """tools/lm_state_trace.py as a module (tools/ is not a package)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "lm_state_trace.py"
    spec = importlib.util.spec_from_file_location("lm_state_trace", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_lm_state_readings_on_a_tiny_cpu_step():
    """tools/lm_state_trace.py's readings: one recorded state a step, the LM loop's; on
    the CPU the kernels' route and both hybrids are the plain version, so their state
    is the plain route's in every lane, no gradient moves and no plane is written; a
    state one ulp apart in one lane's gravity is named."""
    trace = _trace_tool()
    run = _tiny_step()
    states = []
    with smoke.plain_versions(lm=True, nmf=False), trace.recorded_lm_states(states):
        ref = run()
    assert len(states) == 1 and states[0]["camera"].shape == (2, 8)
    readings = trace.run("tiny", run)
    assert set(readings) == {"kernels", *smoke.LM_CONTROL_KINDS, "kernel in the loop alone",
                             "kernel in the final system alone"}
    for name in ("kernels", "kernel in the loop alone", "kernel in the final system alone"):
        got = readings[name]
        assert got["state"]["equal"] == [True, True] and got["state"]["leaves_moved"] == 0
        assert got["state"]["read_leaf_rel"] == 0.0 and got["planes_written"] == []
        assert all(v["apart"] == 0 for v in got["fields"].values())
        assert all(v["apart"] == 0 for v in got["leaves"].values())
    moved = dict(states[0], gravity=states[0]["gravity"].clone())
    moved["gravity"][1, 0] = torch.nextafter(moved["gravity"][1, 0], torch.tensor(1.0))
    reading = trace.lm_state_reading("planted", moved, states[0], ref, ref)
    assert reading["equal"] == [True, False] and reading["apart"]["gravity"] == [1]
    assert reading["apart"]["camera"] == [] and reading["gravity_max_abs"] > 0.0


def test_gate_verdict_names_each_failure_by_its_fields():
    """gate_verdict on a tiny CPU gate: the plain route against itself has no failure;
    the planted gravity fault fails, and each failure is a record (mode, request, lane,
    open, text) whose text names the same mode, request and lane."""
    torch.manual_seed(0)
    cal = geocalib_tpu_torch.GeoCalib(device="cpu", variant="tiny", compute_dtype="float32")
    images, _ = smoke.scenes(np.random.default_rng(0), 2, 64, 64)
    requests = {"a": (cal, images, {"batched": True})}
    with smoke.plain_versions():
        refs = smoke.gate_serve(requests)
    spread = smoke.gate_spread(requests, refs["serving"], ("plain LM, G x (1 + 2^-22)",))
    same = smoke.gate_verdict("plain", refs, refs, spread)
    assert same["ok"] and same["failures"] == []
    with smoke.plain_versions(), smoke.shifted_lm():
        outs = smoke.gate_serve(requests)
    planted = smoke.gate_verdict("planted", outs, refs, spread)
    assert not planted["ok"] and not planted["ok_serving"]
    for f in planted["failures"]:
        assert set(f) == {"mode", "request", "lane", "open", "text"}
        assert f["request"] == "a" and f["lane"] in (0, 1) and f["open"] is False
        assert f["text"].startswith(f"{f['mode']} a[{f['lane']}]: ")
    assert "serving" in {f["mode"] for f in planted["failures"]}
