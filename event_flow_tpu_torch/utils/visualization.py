"""Visualization: flow color wheel, event images, live windows, PNG store
trees.

The port's own copy of event_flow_tpu/utils/visualization.py, numpy only,
so that both packages render and store the same bytes
(tests/test_torch_vis.py holds them bitwise). Arrays arrive NHWC numpy on
the host: the callers bring device tensors over first
(eval_flow.py::WindowOutputs, train/loop.py::Trainer).

- ``flow_to_image``: HSV optical-flow rendering, hue = direction,
  value = per-image min-max-normalized magnitude (the reference's
  colorwheel, visualization.py:229-255)
- ``events_to_image``: green (positive) / red (negative) event counts
  with percentile normalization (visualization.py:269-315)
- ``Visualization``: live OpenCV windows (``update``, only where
  ``DISPLAY`` is set) and per-sequence store trees events/ flow/ iwe/
  frames/ events_window/ flow_window/ iwe_window/ + ``timestamps.txt``
  (``store``, visualization.py:28-227): ``.png`` through cv2 where cv2
  imports, ``.npy`` otherwise, the JAX package's format rule
- ``vis_activity``: per-layer activity log + matplotlib plot
  (visualization.py:318-357); matplotlib is imported only to plot
"""

import os

import numpy as np

__all__ = ["flow_to_image", "events_to_image", "Visualization", "vis_activity"]


def _hsv_to_rgb(hsv):
    """Vectorized HSV->RGB, matplotlib convention (h, s, v all in [0, 1])."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0).astype(np.int32) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    choices = np.stack(
        [
            np.stack([v, t, p], -1),
            np.stack([q, v, p], -1),
            np.stack([p, v, t], -1),
            np.stack([p, q, v], -1),
            np.stack([t, p, v], -1),
            np.stack([v, p, q], -1),
        ]
    )
    return np.take_along_axis(
        np.moveaxis(choices, 0, -2), i[..., None, None], axis=-2
    )[..., 0, :]


def flow_to_image(flow):
    """[H, W, 2] (x, y) flow -> [H, W, 3] uint8 BGR color wheel image.

    Matches the reference's scheme (visualization.py:229-255): hue =
    (atan2(fy, fx) + pi) / 2pi, saturation = 1, value = per-image
    **min-max**-normalized magnitude; the reference builds RGB via
    matplotlib's hsv_to_rgb then converts RGB->BGR before cv2.imwrite
    (visualization.py:180-182) — same stored bytes here."""
    fx, fy = np.asarray(flow[..., 0]), np.asarray(flow[..., 1])
    mag = np.sqrt(fx**2 + fy**2)
    min_mag = mag.min()
    mag_range = mag.max() - min_mag
    ang = (np.arctan2(fy, fx) + np.pi) / (2.0 * np.pi)
    hsv = np.zeros((*mag.shape, 3), np.float64)
    hsv[..., 0] = ang
    hsv[..., 1] = 1.0
    hsv[..., 2] = mag - min_mag
    if mag_range != 0.0:
        hsv[..., 2] /= mag_range
    rgb = (255 * _hsv_to_rgb(hsv)).astype(np.uint8)
    return rgb[..., ::-1]  # BGR for cv2.imwrite


def events_to_image(event_cnt, percentile=99):
    """[H, W, 2] per-polarity counts -> [H, W, 3] uint8 BGR image:
    green = positive, red = negative, percentile-normalized."""
    cnt = np.asarray(event_cnt)
    pos, neg = cnt[..., 0], cnt[..., 1]
    img = np.zeros((*pos.shape, 3), np.uint8)

    def norm(x):
        hi = np.percentile(x[x > 0], percentile) if (x > 0).any() else 1.0
        return np.clip(x / max(hi, 1e-9) * 255, 0, 255).astype(np.uint8)

    img[..., 1] = norm(pos)  # green
    img[..., 2] = norm(neg)  # red (BGR)
    return img


class Visualization:
    """Live windows + PNG dump trees (reference: visualization.py:10-227)."""

    def __init__(self, config, eval_id=-1, path_results=None, show=None):
        self.px = int(config.get("vis", {}).get("px", 400))
        self.eval_id = eval_id
        self.path_results = path_results
        if show is None:
            show = bool(os.environ.get("DISPLAY"))
        self.show = show
        self.store_dir = None
        if path_results is not None:
            self.store_dir = os.path.join(
                path_results, f"eval_{eval_id}" if eval_id >= 0 else "vis"
            )
        self._store_idx = {}

    def _imshow(self, name, img):
        if not self.show:
            return
        try:  # pragma: no cover - needs a display
            import cv2

            cv2.namedWindow(name, cv2.WINDOW_NORMAL)
            cv2.resizeWindow(name, self.px, self.px)
            cv2.imshow(name, img)
            cv2.waitKey(1)
        except Exception:
            self.show = False

    def update(self, batch=None, flow=None, iwe=None, events_window=None,
               masked_window_flow=None, iwe_window=None):
        """Render the first batch element of each provided tensor."""
        if batch is not None and "event_cnt" in batch:
            self._imshow("events", events_to_image(batch["event_cnt"][0]))
        if flow is not None:
            self._imshow("flow", flow_to_image(np.asarray(flow)[0]))
        if iwe is not None:
            self._imshow("iwe", events_to_image(np.asarray(iwe)[0]))
        if events_window is not None:
            self._imshow("events_window",
                         events_to_image(np.asarray(events_window)[0]))
        if masked_window_flow is not None:
            self._imshow("flow_window",
                         flow_to_image(np.asarray(masked_window_flow)[0]))
        if iwe_window is not None:
            self._imshow("iwe_window",
                         events_to_image(np.asarray(iwe_window)[0]))

    def store(self, sequence, batch=None, flow=None, iwe=None, ts=None,
              events_window=None, masked_window_flow=None, iwe_window=None):
        """PNG store tree per sequence (reference: visualization.py:120-227)."""
        if self.store_dir is None:
            return
        root = os.path.join(self.store_dir, sequence)
        idx = self._store_idx.get(sequence, 0)

        def write(sub, img):
            d = os.path.join(root, sub)
            os.makedirs(d, exist_ok=True)
            try:
                import cv2

                cv2.imwrite(os.path.join(d, f"{idx:09d}.png"), img)
            except ImportError:  # pragma: no cover
                np.save(os.path.join(d, f"{idx:09d}.npy"), img)

        if batch is not None and "event_cnt" in batch:
            write("events", events_to_image(np.asarray(batch["event_cnt"])[0]))
        if batch is not None and "frames" in batch:
            # APS grayscale frames (frames mode; reference
            # visualization.py:153-163 stores frames/ trees)
            fr = np.asarray(batch["frames"])[0]
            write("frames", fr[0].astype(np.uint8))
        if flow is not None:
            write("flow", flow_to_image(np.asarray(flow)[0]))
        if iwe is not None:
            write("iwe", events_to_image(np.asarray(iwe)[0]))
        if events_window is not None:
            write("events_window", events_to_image(np.asarray(events_window)[0]))
        if masked_window_flow is not None:
            write("flow_window",
                  flow_to_image(np.asarray(masked_window_flow)[0]))
        if iwe_window is not None:
            write("iwe_window", events_to_image(np.asarray(iwe_window)[0]))
        if ts is not None:
            os.makedirs(root, exist_ok=True)
            with open(os.path.join(root, "timestamps.txt"), "a") as f:
                f.write(f"{idx:09d} {float(ts)}\n")
        self._store_idx[sequence] = idx + 1


def vis_activity(activity, activity_log=None, path=None):
    """Accumulate per-layer spike/activity fractions and optionally plot
    (reference: visualization.py:318-357). Returns the updated log."""
    if activity is None:
        return activity_log
    log = activity_log or {k: [] for k in activity}
    for k, v in activity.items():
        log.setdefault(k, []).append(float(v))
    if path is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 4))
        for k, vals in sorted(log.items()):
            ax.plot(vals, label=k)
        ax.set_xlabel("forward pass")
        ax.set_ylabel("fraction nonzero")
        ax.legend(fontsize=6)
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return log
