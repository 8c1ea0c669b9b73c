"""Benchmark registry, data preparation and the per-benchmark CLI.

Port of geocalib_tpu/eval/benchmarks.py. Each benchmark is a row (data
directory, download URL, eval camera model); ``prepare_benchmark`` finds the
data under data/<name> or fetches and extracts the released zip, whose
``images/`` and CSV of GT rows are what the datasets read. Variable-size
downloads go through the shape-bucketed BenchmarkPipeline, generated sets
through the SimplePipeline. A missing ``openpano_synth`` is generated from
procedural panoramas (``data/generate.py``, 24 panoramas, 320² crops, as the
JAX package does); the other ``openpano*`` sets need OpenPano panoramas, and
their error names the generator's command.

CLI (the card by default; --device cpu runs the plain versions on the CPU):
    python -m geocalib_tpu_torch.eval.benchmarks openpano_synth \\
        --weights weights/geocalib_synth_r05.msgpack [--device cpu]
"""

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

DATA_PATH = Path("data")
EVAL_PATH = Path("outputs/results")


@dataclasses.dataclass(frozen=True)
class Benchmark:
    name: str
    url: Optional[str]
    camera_model: str = "pinhole"
    # released zips hold images/ and images.csv of variable-size images;
    # generated sets have split CSVs
    csv_name: str = "images.csv"
    # Stanford2D3D asks users to accept the dataset's terms
    requires_terms: bool = False

    @property
    def variable_size(self) -> bool:
        """Released downloads mix image sizes: the shape-bucketed eval path."""
        return self.url is not None


BENCHMARKS: Dict[str, Benchmark] = {
    "lamar2k": Benchmark(
        "lamar2k", "https://cvg-data.inf.ethz.ch/GeoCalib_ECCV2024/lamar2k.zip"
    ),
    "megadepth2k": Benchmark(
        "megadepth2k", "https://cvg-data.inf.ethz.ch/GeoCalib_ECCV2024/megadepth2k.zip"
    ),
    "megadepth2k_radial": Benchmark(
        "megadepth2k_radial",
        "https://cvg-data.inf.ethz.ch/GeoCalib_ECCV2024/megadepth2k-radial.zip",
        camera_model="simple_radial",
    ),
    "tartanair": Benchmark(
        "tartanair", "https://cvg-data.inf.ethz.ch/GeoCalib_ECCV2024/tartanair.zip"
    ),
    "stanford2d3d": Benchmark(
        "stanford2d3d",
        "https://cvg-data.inf.ethz.ch/GeoCalib_ECCV2024/stanford2d3d.zip",
        requires_terms=True,
    ),
    # generated from OpenPano panoramas
    "openpano": Benchmark("openpano", None, csv_name="test.csv"),
    "openpano_radial": Benchmark(
        "openpano_radial", None, camera_model="simple_radial", csv_name="test.csv"
    ),
    # fully procedural
    "openpano_synth": Benchmark("openpano_synth", None, csv_name="test.csv"),
}


def prepare_benchmark(name: str, data_path: Path = DATA_PATH, device=None) -> Path:
    """The benchmark's directory; generates ``openpano_synth`` (rendering on
    `device`, the card by default) or downloads and extracts a released zip if needed."""
    bench = BENCHMARKS[name]
    target = data_path / bench.name
    if (target / bench.csv_name).exists():
        return target

    if bench.name == "openpano_synth":
        from geocalib_tpu_torch.data.generate import generate_dataset

        generate_dataset(str(target), n_panos=24, camera_model=bench.camera_model, height=320,
                         width=320, device=device)
        return target

    if bench.url is None:
        raise FileNotFoundError(
            f"benchmark {name!r} must be generated from panoramas first; run "
            f"python -m geocalib_tpu_torch.data.generate --out_dir {target} "
            f"--pano_dir <openpano panos>"
        )

    if bench.requires_terms:
        print(
            "NOTE: Stanford2D3D requires accepting the dataset terms of use: "
            "https://docs.google.com/forms/d/e/1FAIpQLScFR0U8WEUtb7tgjOhhnl31OrkEs73-Y8bQwPeXgebqVKNMpQ/viewform"
        )

    import io
    import urllib.request
    import zipfile

    target.parent.mkdir(parents=True, exist_ok=True)
    print(f"downloading {bench.url} ...")
    try:
        with urllib.request.urlopen(bench.url, timeout=60) as resp:
            payload = resp.read()
    except Exception as e:  # zero-egress environments
        raise RuntimeError(
            f"could not download {bench.url} ({e}); fetch the zip manually and "
            f"extract it to {target}"
        ) from e
    with zipfile.ZipFile(io.BytesIO(payload)) as zf:
        zf.extractall(target.parent)
    return target


def run_benchmark(name: str, weights=None, data_path: Path = DATA_PATH,
                  experiment_dir: Optional[Path] = None, device=None,
                  **eval_kw) -> Dict[str, float]:
    """Prepare and evaluate a benchmark; returns the summaries. weights: a msgpack
    path, a state_dict or None (random initialization)."""
    from geocalib_tpu_torch.eval.pipeline import evaluate_benchmark, evaluate_real_benchmark

    bench = BENCHMARKS[name]
    target = prepare_benchmark(name, data_path, device)
    exp = str(experiment_dir) if experiment_dir else None
    if bench.variable_size:
        return evaluate_real_benchmark(weights, str(target), camera_model=bench.camera_model,
                                       experiment_dir=exp, csv_name=bench.csv_name,
                                       device=device, **eval_kw)
    return evaluate_benchmark(weights, str(target), split=bench.csv_name.replace(".csv", ""),
                              camera_model=bench.camera_model, experiment_dir=exp,
                              device=device, **eval_kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("benchmark", choices=sorted(BENCHMARKS))
    ap.add_argument("--weights", default=None, help="params .msgpack (random if omitted)")
    ap.add_argument("--variant", default="b")
    ap.add_argument("--data_path", default=str(DATA_PATH))
    ap.add_argument("--output", default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if not args.weights:
        import torch

        print("WARNING: no --weights given; evaluating a randomly initialized net")
        torch.manual_seed(0)
    out_dir = Path(args.output) if args.output else EVAL_PATH / args.benchmark
    summary = run_benchmark(args.benchmark, args.weights, data_path=Path(args.data_path),
                            experiment_dir=out_dir, device=args.device, variant=args.variant,
                            batch_size=args.batch_size)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
