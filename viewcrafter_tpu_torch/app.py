"""Gradio web demo (single_view_txt mode): the port's own copy of the JAX
package's `app.py`, after the reference's demo (gradio_app.py:19-91 +
viewcrafter.py:436-462). Upload one image, set elevation / center_scale and
free-form d_phi / d_theta / d_r sequences, get the camera trajectory's video
and the diffused novel-view video.

    python -m viewcrafter_tpu_torch.app            # on the card
    python -m viewcrafter_tpu_torch.app --device cpu

gradio and PIL are imported when the demo is built and run, so the rest of
the port never needs them. The pipeline runs on the card unless
`build_demo` is given device="cpu".
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

# reference gradio_app.py:8-14 i2v_examples (the same images, in test/images)
EXAMPLES = [
    ["test/images/boy.png", 0, 1.0, "0 40", "0 0", "0 0", 50, 123],
    ["test/images/car.jpg", 0, 1.0, "0 -35", "0 0", "0 -0.1", 50, 123],
    ["test/images/fruit.png", 0, 1.0, "0 -3 -15 -20 -17 -5 0",
     "0 -2 -5 -10 -8 -5 0 2 5 3 0", "0 0", 50, 123],
    ["test/images/room.png", 10, 1.0, "0 3 10 20 17 10 0",
     "0 -2 -8 -6 0 2 5 3 0", "0 -0.02 -0.09 -0.16 -0.09 0", 50, 123],
    ["test/images/castle.png", 0, 1.0, "0 30",
     "0 -1 -5 -4 0 1 5 4 0", "0 -0.2", 50, 123],
]


def parse_seq(text, name: str) -> list:
    """'0 -3 -15' -> [0.0, -3.0, -15.0] (reference viewcrafter.py:439)."""
    vals = [float(v) for v in str(text).split()]
    if not vals:
        raise ValueError(f"{name} sequence is empty; it should start with 0")
    return vals


def build_demo(opts=None, device=None):
    try:
        import gradio as gr
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "gradio is not installed in this environment; the CLI "
            "(python -m viewcrafter_tpu_torch.cli) provides the same functionality") from e

    from viewcrafter_tpu_torch.pipeline import InferenceOptions, ViewCrafterPipeline

    opts = opts or InferenceOptions(mode="single_view_txt")
    pipeline = ViewCrafterPipeline(opts, device=device)

    def run(image, elevation, center_scale, d_phi, d_theta, d_r, steps, seed):
        from PIL import Image

        workdir = tempfile.mkdtemp(prefix="viewcrafter_")
        img_path = os.path.join(workdir, "input.png")
        if isinstance(image, str):  # the examples pass a path
            Image.open(image).convert("RGB").save(img_path)
        else:
            Image.fromarray(np.asarray(image)).save(img_path)
        # one line per axis: the single_view_txt trajectory file
        traj_path = os.path.join(workdir, "traj.txt")
        with open(traj_path, "w") as f:
            for text, name in ((d_phi, "d_phi"), (d_theta, "d_theta"), (d_r, "d_r")):
                f.write(" ".join(map(str, parse_seq(text, name))) + "\n")

        o = pipeline.opts
        o.image_dir, o.out_dir, o.exp_name = img_path, workdir, "gradio"
        o.mode, o.traj_txt = "single_view_txt", traj_path
        o.elevation, o.center_scale = float(elevation), float(center_scale)
        o.ddim_steps = int(steps)
        pipeline.generator.manual_seed(int(seed))
        pipeline.run()

        def artifact(name):
            # the video writers fall back to a PNG directory without ffmpeg
            p = os.path.join(o.save_dir, name)
            return p if os.path.exists(p) else p + ".frames"

        # the reference's run_gradio returns (viz_traj.mp4, diffusion0.mp4)
        return artifact("viz_traj.mp4"), artifact("diffusion0.mp4")

    with gr.Blocks(title="ViewCrafter") as demo:
        gr.Markdown("# ViewCrafter: novel view synthesis from one image")
        with gr.Row():
            with gr.Column():
                image = gr.Image(label="Input Image")
                elevation = gr.Slider(-45, 45, value=5, step=1, label="elevation")
                center_scale = gr.Slider(0.1, 2.0, value=1.0, step=0.1, label="center_scale")
                d_phi = gr.Text(label="d_phi sequence, should start with 0")
                d_theta = gr.Text(label="d_theta sequence, should start with 0")
                d_r = gr.Text(label="d_r sequence, should start with 0")
                steps = gr.Slider(1, 50, value=50, step=1, label="Sampling steps")
                seed = gr.Slider(0, 2 ** 31, value=123, step=1, label="Random Seed")
                btn = gr.Button("Generate")
            with gr.Column():
                traj_out = gr.Video(label="Camera Trajectory")
                diffusion_out = gr.Video(label="Generated Video")
        inputs = [image, elevation, center_scale, d_phi, d_theta, d_r, steps, seed]
        outputs = [traj_out, diffusion_out]
        if hasattr(gr, "Examples"):
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            examples = [[os.path.join(root, e[0])] + e[1:] for e in EXAMPLES
                        if os.path.exists(os.path.join(root, e[0]))]
            if examples:
                gr.Examples(examples=examples, inputs=inputs, outputs=outputs, fn=run,
                            cache_examples=False)
        btn.click(run, inputs, outputs)
    return demo


if __name__ == "__main__":  # pragma: no cover
    import argparse

    parser = argparse.ArgumentParser(description="viewcrafter_tpu_torch gradio demo")
    parser.add_argument("--device", default=None,
                        help="torch device; default the card (cuda), and an error without one")
    build_demo(device=parser.parse_args().device).launch()
