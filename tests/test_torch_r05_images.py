"""GeoCalib.calibrate on the committed weights and images, the port against the
JAX package, on the CPU (slow: MSCAN-B in float32 in both packages).

Both GeoCalibs load weights/geocalib_synth_r05.msgpack and calibrate 4 views
of the committed data/openpano_synth test split through calibrate_path. Roll,
pitch, vFoV and the roll, pitch, gravity and vFoV uncertainties (radians)
follow the stop_at rule of tests/test_torch_calibrate.py: within 2e-4 where
both solvers stop at the same iteration, within 1e-2 where they stop one
iteration apart, never further apart. Each answer is printed beside its row
of test.csv; the CSV is not a gate (the network is not exact).
"""

import csv
import math
from pathlib import Path

import numpy as np
import pytest

from geocalib_tpu.extractor import GeoCalib as JGeoCalib
from geocalib_tpu_torch import GeoCalib

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "weights" / "geocalib_synth_r05.msgpack"
SYNTH = ROOT / "data" / "openpano_synth"
ROWS = (0, 1, 2, 3)
UNCERTAINTIES = ("roll_uncertainty", "pitch_uncertainty", "gravity_uncertainty",
                 "vfov_uncertainty")


@pytest.mark.slow
def test_calibrate_r05_on_committed_images():
    with open(SYNTH / "test.csv") as fh:
        rows = [r for i, r in enumerate(csv.DictReader(fh)) if i in ROWS]
    jcal = JGeoCalib(weights=str(WEIGHTS), compute_dtype="float32")
    tcal = GeoCalib(weights=WEIGHTS, device="cpu", compute_dtype="float32")
    deg = math.degrees
    for row in rows:
        path = SYNTH / "images" / row["fname"]
        ref = jcal.calibrate_path(path)
        out = tcal.calibrate_path(path)
        values = {
            "roll": (float(out["gravity"].roll), float(ref["gravity"].roll)),
            "pitch": (float(out["gravity"].pitch), float(ref["gravity"].pitch)),
            "vfov": (float(out["camera"].vfov), float(ref["camera"].vfov)),
            **{k: (float(out[k]), float(ref[k])) for k in UNCERTAINTIES},
        }
        stop, ref_stop = int(out["stop_at"]), int(ref["stop_at"])
        print(f"{row['fname']}: csv roll/pitch/vfov {deg(float(row['roll'])):.3f} "
              f"{deg(float(row['pitch'])):.3f} {deg(float(row['vfov'])):.3f} deg; port "
              f"{deg(values['roll'][0]):.3f} {deg(values['pitch'][0]):.3f} "
              f"{deg(values['vfov'][0]):.3f}; jax {deg(values['roll'][1]):.3f} "
              f"{deg(values['pitch'][1]):.3f} {deg(values['vfov'][1]):.3f}; stop_at {stop}/{ref_stop}; "
              f"largest |port - jax| {max(abs(a - b) for a, b in values.values()):.2e} rad")
        assert abs(stop - ref_stop) <= 1, (row["fname"], stop, ref_stop)
        tol = 2e-4 if stop == ref_stop else 1e-2
        for k, (a, b) in values.items():
            assert np.isfinite(a) and abs(a - b) <= tol, (row["fname"], k, a, b)
