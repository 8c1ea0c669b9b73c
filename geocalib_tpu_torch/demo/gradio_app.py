"""Gradio web demo (optional).

Port of geocalib_tpu/demo/gradio_app.py: a camera-model dropdown, field
overlays and an undistorted preview. Needs `pip install gradio`, which is
imported inside ``build_app`` only and raises with that advice where it is
absent. The calibration runs on the card unless ``--device cpu`` is given.

    python -m geocalib_tpu_torch.demo.gradio_app --weights params.msgpack
"""

import argparse

import numpy as np


def build_app(weights=None, variant: str = "b", device=None):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError("the web demo requires `pip install gradio`") from e

    import math

    import torch

    from geocalib_tpu_torch.demo.demo import annotate
    from geocalib_tpu_torch.extractor import GeoCalib

    calib = GeoCalib(weights=weights, variant=variant, device=device)

    def inference(img, camera_model, show_up, show_lat, undistort):
        image = np.asarray(img, np.float32) / 255.0
        result = calib.calibrate(image, camera_model=camera_model)
        show = ["horizon"] + (["up"] if show_up else []) + (["latitude"] if show_lat else [])
        overlay = annotate(image, result, show=show)
        cam = result["camera"]
        text = (
            f"roll {math.degrees(float(result['gravity'].roll)):.1f}°  "
            f"pitch {math.degrees(float(result['gravity'].pitch)):.1f}°  "
            f"vfov {math.degrees(float(cam.vfov)):.1f}°  "
            f"focal {float(cam.f[1]):.1f}px"
        )
        if undistort and camera_model != "pinhole":
            img_t = torch.as_tensor(image, device=cam.f.device)[None]
            und = cam[None].undistort_image(img_t)[0]
            overlay = (und.cpu().numpy() * 255).astype(np.uint8)
        return overlay, text

    demo = gr.Interface(
        fn=inference,
        inputs=[
            gr.Image(label="image"),
            gr.Dropdown(["pinhole", "simple_radial", "radial", "simple_divisional"],
                        value="pinhole", label="camera model"),
            gr.Checkbox(True, label="show up field"),
            gr.Checkbox(True, label="show latitude"),
            gr.Checkbox(False, label="undistort"),
        ],
        outputs=[gr.Image(label="calibration"), gr.Textbox(label="estimate")],
        title="GeoCalib (PyTorch)",
    )
    return demo


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--variant", default="b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--port", type=int, default=7860)
    args = ap.parse_args(argv)
    build_app(args.weights, args.variant, args.device).launch(server_port=args.port)


if __name__ == "__main__":
    main()
