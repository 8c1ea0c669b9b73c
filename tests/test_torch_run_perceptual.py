"""The port's perceptual-baseline driver against the JAX package's.

``parse_result`` reads the dashboard's text; on the pattern's cases (signs,
decimals, integers, ``nan`` fields, and texts it must refuse) both packages
give the same floats or the same refusal. The driver needs selenium, which
is hidden here (``sys.modules`` entry None) so that no test can reach the
dashboard: ``run`` raises a clear ImportError and the CLI exits with it.
"""

import math
import sys

import pytest

from geocalib_tpu.eval import run_perceptual as jperc
from geocalib_tpu_torch.eval import run_perceptual as tperc

TEXTS = [
    "Pitch: 12.5° / Roll: -3.25° / HFOV : 60.0° / Distortion: 0.1",
    "Pitch: -0.5° / Roll: 0° / HFOV : 75° / Distortion: -0.25",
    "Pitch: nan° / Roll: nan° / HFOV : nan° / Distortion: nan",
    "Pitch: .5° / Roll: -.75° / HFOV : 90.° / Distortion: 0",
    "Pitch: 1° / Roll: 2° / HFOV : 3° / Distortion: 4 (trailing text)",
]
BAD = [
    "",
    "Estimating...",
    "Pitch: 1 / Roll: 2° / HFOV : 3° / Distortion: 4",
    "pitch: 1° / roll: 2° / hfov : 3° / distortion: 4",
    "Roll: 2° / Pitch: 1° / HFOV : 3° / Distortion: 4",
]


def _same(a, b):
    return all((math.isnan(x) and math.isnan(y)) or x == y for x, y in zip(a, b))


@pytest.mark.parametrize("text", TEXTS)
def test_parse_result_matches_jax(text):
    got, want = tperc.parse_result(text), jperc.parse_result(text)
    assert len(got) == 4 and _same(got, want)


@pytest.mark.parametrize("text", BAD)
def test_parse_result_refuses_as_jax(text):
    with pytest.raises(ValueError, match="cannot parse dashboard result") as t:
        tperc.parse_result(text)
    with pytest.raises(ValueError) as j:
        jperc.parse_result(text)
    assert str(t.value) == str(j.value)


def test_without_selenium_the_cli_fails_clearly(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "selenium", None)
    with pytest.raises(ImportError, match="needs selenium"):
        tperc.run(tmp_path, tmp_path / "results.json")
    with pytest.raises(SystemExit, match="run_perceptual: .*needs selenium"):
        tperc.main([str(tmp_path), str(tmp_path / "results.json")])
    assert not (tmp_path / "results.json").exists()
    assert tperc.DASHBOARD_URL == jperc.DASHBOARD_URL
