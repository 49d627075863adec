"""VisualSORT whole-sequence pipeline on the fused kernel (the JAX
package's `examples/visual_pallas_pipeline.py`, whose fused engine is a
Pallas kernel).

`run_sequence_device_visual(engine="fused")` runs the whole tracker
(ReID gallery distances, cascade voting, Kalman updates, gallery
maintenance) as one CUDA kernel launch per 16-frame chunk after the
chunk's gallery product (`ops/fused_visual.py`); `engine="step"` runs the
general step frame by frame.  Both engines give the same ids, as this
demo asserts.  Under `--device cpu` the fused engine runs the kernels'
plain versions.
"""

from similari_tpu_torch.eval import run_sequence_device_visual
from similari_tpu_torch.eval.synthetic import generate_sequence
from similari_tpu_torch.examples import example_device, fast


def main(argv=None):
    dev = example_device(argv, __doc__)
    if fast():  # the smoke size
        objects, frames, fdim = 6, 12, 8
    else:
        objects, frames, fdim = 20, 100, 128
    gt, dets, feats = generate_sequence(
        n_objects=objects, n_frames=frames, seed=7,
        p_miss=0.1, fp_per_frame=0.2, feature_dim=fdim,
    )
    pred_step, fps_step = run_sequence_device_visual(
        dets, feats, capacity=64, engine="step", device=dev)
    pred_fused, fps_fused = run_sequence_device_visual(
        dets, feats, capacity=64, engine="fused", device=dev)
    assert pred_step == pred_fused, "engines must agree on every track id"
    n_tracks = len({tid for rows in pred_fused.values()
                    for tid, *_ in rows})
    print(
        f"{frames} frames x {objects} objects: {n_tracks} tracks; "
        f"step {fps_step:.0f} FPS, fused {fps_fused:.0f} FPS (id-exact)"
    )


if __name__ == "__main__":
    main()
