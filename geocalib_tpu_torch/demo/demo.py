"""Calibration demo: annotate images with horizon, up and latitude overlays.

Port of geocalib_tpu/demo/demo.py: calibrates single images, directories,
or a webcam stream where OpenCV is present, prints the calibration and writes
annotated images. ``annotate`` draws with matplotlib, ``InteractiveDemo``'s
frames with the numpy overlays (``demo/overlays.py``); OpenCV is needed only
by the webcam loop (``InteractiveDemo.run``). Each is imported inside the
function that uses it. The calibration runs on the card unless ``--device
cpu`` is given.

CLI:
    python -m geocalib_tpu_torch.demo.demo path/to/img.jpg --out annotated.jpg \\
        --weights weights/geocalib_synth_r05.msgpack
    python -m geocalib_tpu_torch.demo.demo path/to/dir --out out_dir --camera_model simple_radial
"""

import argparse
import math
from pathlib import Path

import numpy as np


def _has_distortion(camera) -> bool:
    return float(camera.k.abs().max()) > 0


def print_calibration(result) -> None:
    """Console report of one image's calibration."""
    cam, grav = result["camera"], result["gravity"]
    print("\nEstimated parameters (Pred):")
    print(f"Roll:  {math.degrees(float(grav.roll)):.1f}° "
          f"(± {math.degrees(float(result.get('roll_uncertainty', 0.0))):.1f})°")
    print(f"Pitch: {math.degrees(float(grav.pitch)):.1f}° "
          f"(± {math.degrees(float(result.get('pitch_uncertainty', 0.0))):.1f})°")
    print(f"vFoV:  {math.degrees(float(cam.vfov)):.1f}° "
          f"(± {math.degrees(float(result.get('vfov_uncertainty', 0.0))):.1f})°")
    print(f"Focal: {float(cam.f[1]):.1f} px "
          f"(± {float(result.get('focal_uncertainty', 0.0)):.1f})")
    if _has_distortion(cam):
        print(f"K1:    {float(cam.k[0]):.2f}")


def annotate(image, result, show=("horizon", "up", "latitude")) -> np.ndarray:
    """Render the overlays into a matplotlib figure and return it as an RGB array."""
    from geocalib_tpu_torch.visualization.viz2d import (_plt, plot_horizon_lines, plot_images,
                                                        plot_latitudes, plot_vector_fields)

    plt = _plt()
    fig, axs = plot_images([image])
    if "up" in show:
        plot_vector_fields(axs, [result["up_field"]])
    if "latitude" in show:
        plot_latitudes(axs, [result["latitude_field"]])
    if "horizon" in show:
        plot_horizon_lines(axs, result["camera"][None], result["gravity"][None])
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


class InteractiveDemo:
    """Live webcam loop with overlay toggles on keys: h=horizon u=up l=latitude
    c=confidence d=undistort g=grid b=box, 1/2/3 switch the camera model
    (pinhole/simple_radial/simple_divisional), q quits. The frame rate and the
    calibration are written on each frame."""

    KEYMAP = {
        "h": "horizon",
        "u": "up",
        "l": "latitude",
        "c": "confidence",
        "d": "undistort",
        "g": "grid",
        "b": "box",
    }
    MODELS = {"1": "pinhole", "2": "simple_radial", "3": "simple_divisional"}

    def __init__(self, calibrator, camera_id: int = 0):
        self.calibrator = calibrator
        self.camera_id = camera_id
        self.camera_model = "pinhole"
        self.toggles = {
            "horizon": True,
            "up": True,
            "latitude": False,
            "confidence": False,
            "undistort": False,
            "grid": False,
            "box": False,
        }

    def handle_key(self, key: str) -> bool:
        """Update the toggles or the camera model; returns True to quit."""
        if key in self.KEYMAP:
            name = self.KEYMAP[key]
            self.toggles[name] = not self.toggles[name]
        elif key in self.MODELS:
            self.camera_model = self.MODELS[key]
        elif key in ("q", "\x1b"):
            return True
        return False

    def format_results(self, result) -> str:
        cam, grav = result["camera"], result["gravity"]
        text = f"{self.camera_model.replace('_', ' ').title()}\n"
        text += (f"Roll:  {math.degrees(float(grav.roll)):.2f} "
                 f"(+- {math.degrees(float(result.get('roll_uncertainty', 0.0))):.2f})\n")
        text += (f"Pitch: {math.degrees(float(grav.pitch)):.2f} "
                 f"(+- {math.degrees(float(result.get('pitch_uncertainty', 0.0))):.2f})\n")
        text += (f"vFoV:  {math.degrees(float(cam.vfov)):.2f} "
                 f"(+- {math.degrees(float(result.get('vfov_uncertainty', 0.0))):.2f})\n")
        text += (f"Focal: {float(cam.f[1]):.2f} "
                 f"(+- {float(result.get('focal_uncertainty', 0.0)):.2f})")
        if _has_distortion(cam):
            text += f"\nK1:    {float(cam.k[0]):.2f}"
        return text

    def process_frame(self, rgb: np.ndarray):
        """Calibrate one RGB frame and draw the enabled overlays: (frame, result)."""
        from geocalib_tpu_torch.demo.overlays import render_overlays

        result = self.calibrator.calibrate(rgb, camera_model=self.camera_model)
        return render_overlays(rgb, result, self.toggles), result

    def run(self) -> None:
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                "webcam mode needs opencv-python; use image/directory mode instead"
            ) from e
        import time

        cap = cv2.VideoCapture(self.camera_id)
        while True:
            ok, frame = cap.read()
            if not ok:
                print("Error: failed to retrieve frame")
                break
            t0 = time.time()
            rgb = frame[..., ::-1].astype(np.float32) / 255.0
            out, result = self.process_frame(rgb)
            bgr = (np.clip(out, 0, 1) * 255).astype(np.uint8)[..., ::-1].copy()
            for i, line in enumerate(self.format_results(result).split("\n")):
                cv2.putText(bgr, line, (8, 20 + 18 * i), cv2.FONT_HERSHEY_SIMPLEX,
                            0.5, (255, 255, 255), 1)
            fps = 1.0 / max(time.time() - t0, 1e-6)
            cv2.putText(bgr, f"FPS: {fps:04.1f}", (bgr.shape[1] - 110, bgr.shape[0] - 10),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
            cv2.imshow("geocalib_tpu_torch demo", bgr)
            key = cv2.waitKey(1) & 0xFF
            if key != 255 and self.handle_key(chr(key)):
                break
        cap.release()


def run_webcam(calibrator, camera_id: int = 0) -> None:
    """Live webcam loop (needs OpenCV)."""
    InteractiveDemo(calibrator, camera_id).run()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", help="image file, directory, or 'webcam'")
    ap.add_argument("--out", default=None, help="output file or directory")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--camera_model", default="pinhole")
    ap.add_argument("--variant", default="b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from geocalib_tpu_torch.extractor import GeoCalib
    from geocalib_tpu_torch.utils.image import load_image, write_image

    calib = GeoCalib(weights=args.weights, variant=args.variant, device=args.device)

    if args.path == "webcam":
        run_webcam(calib)
        return

    src = Path(args.path)
    paths = (sorted(p for p in src.iterdir() if p.suffix.lower() in (".jpg", ".png", ".jpeg"))
             if src.is_dir() else [src])
    for p in paths:
        img = load_image(p)
        result = calib.calibrate(img, camera_model=args.camera_model)
        print(f"\n=== {p.name} ===")
        print_calibration(result)
        if args.out:
            out = Path(args.out)
            dst = out / f"{p.stem}_annotated.jpg" if src.is_dir() else out
            dst.parent.mkdir(parents=True, exist_ok=True)
            write_image(annotate(img, result) / 255.0, dst)
            print(f"annotated -> {dst}")


if __name__ == "__main__":
    main()
