"""Perceptual-baseline driver (TPAMI 2023 "Deep Perceptual Measure").

Port of geocalib_tpu/eval/run_perceptual.py: the baseline is the paper's
public web dashboard, driven through Selenium to collect pitch, roll, HFoV
and distortion predictions into a JSON that the benchmark tables read.
There is no model to run; the driver is the whole module.

Needs ``selenium`` and a geckodriver, imported inside ``run``: without
them the CLI fails with a clear message before it contacts anything.

CLI:
    python -m geocalib_tpu_torch.eval.run_perceptual <image_dir> <results.json>
"""

import argparse
import json
import re
import time
from pathlib import Path
from typing import Dict, Tuple

DASHBOARD_URL = "http://rachmaninoff.gel.ulaval.ca:8005/"
RESULT_PATTERN = re.compile(
    r"Pitch: (nan|-?\d*\.?\d*)° / Roll: (nan|-?\d*\.?\d*)° / "
    r"HFOV : (nan|-?\d*\.?\d*)° / Distortion: (nan|-?\d*\.?\d*)"
)


def parse_result(text: str) -> Tuple[float, float, float, float]:
    """Dashboard text → (pitch°, roll°, hfov°, distortion)."""
    match = RESULT_PATTERN.match(text)
    if match is None:
        raise ValueError(f"cannot parse dashboard result: {text!r}")
    return tuple(float(g) for g in match.groups())


def run(image_dir: Path, results_path: Path, timeout_s: float = 60.0) -> Dict:
    try:
        from selenium import webdriver
        from selenium.webdriver.common.by import By
    except ImportError as e:
        raise ImportError(
            "the perceptual baseline drives an external web demo and needs "
            "selenium + geckodriver; it is a comparison baseline, not part "
            "of the port"
        ) from e

    options = webdriver.FirefoxOptions()
    options.add_argument("--headless")
    driver = webdriver.Firefox(options=options)
    try:
        driver.get(DASHBOARD_URL)
        time.sleep(5)
        result_div = driver.find_element(By.ID, "estimated-parameters-display")
        upload = driver.find_element(By.ID, "dash-uploader")

        results: Dict[str, Tuple[float, float, float, float]] = {}
        prev = str(result_div.text)
        for path in sorted(image_dir.iterdir()):
            upload.send_keys(str(path.absolute()))
            started = time.time()
            while True:
                text = result_div.text
                if text and text != prev:
                    break
                if time.time() - started > timeout_s:
                    raise TimeoutError(f"dashboard timed out on {path.name}")
                time.sleep(0.5)
            prev = text
            try:
                results[path.name] = parse_result(text)
            except ValueError as e:
                print(e)
        results_path.write_text(json.dumps(results))
        return results
    finally:
        driver.quit()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("images", type=Path)
    ap.add_argument("results", type=Path)
    args = ap.parse_args(argv)
    try:
        run(args.images, args.results)
    except ImportError as e:
        raise SystemExit(f"run_perceptual: {e}") from e


if __name__ == "__main__":
    main()
