"""True-3D matplotlib scene rendering — the port's own copy of
tools/visual_utils/pyplot_vis_utils.py:47-186 (no open3d / mayavi): point
cloud scatter, 12-edge box wireframes (ground truth blue, predictions
coloured per class with score tags) and a ground grid through
mpl_toolkits.mplot3d. matplotlib is imported inside the drawing
functions, so importing this module needs only numpy.

API: draw_scenes(points, gt_boxes, ref_boxes, ref_scores, ref_labels), the
reference's signature, and save_scene(...) to write a PNG headlessly.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ...utils.geometry_np import boxes_to_corners_3d

# per-class wireframe colors (open3d_vis_utils.py box_colormap equivalent)
box_colormap = [
    (1.0, 1.0, 1.0),
    (0.0, 1.0, 0.0),
    (0.0, 1.0, 1.0),
    (1.0, 1.0, 0.0),
    (1.0, 0.0, 1.0),
    (0.3, 0.6, 1.0),
    (1.0, 0.5, 0.0),
    (0.5, 1.0, 0.5),
    (0.8, 0.2, 0.2),
    (0.6, 0.4, 1.0),
    (0.2, 0.8, 0.8),
]

# the 12 edges of a boxes_to_corners_3d box: 4 bottom, 4 top, 4 vertical
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
          (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def _as_np(x):
    if x is None:
        return None
    return np.asarray(x)


def _make_fig(bgcolor=(0, 0, 0), size=(12, 12)):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=size, facecolor=bgcolor)
    ax = fig.add_subplot(111, projection="3d", facecolor=bgcolor)
    ax.set_axis_off()
    return fig, ax


def visualize_pts(pts, fig=None, bgcolor=(0, 0, 0), show_intensity=False,
                  max_pts=60000, point_size=0.15):
    """3D point scatter, z-colored (or intensity-colored). Subsamples to
    max_pts for draw speed on 300k-point sweeps."""
    pts = _as_np(pts)
    if fig is None:
        fig, ax = _make_fig(bgcolor)
    else:
        ax = fig.gca()
    if pts.shape[0] > max_pts:
        sel = np.random.RandomState(0).choice(pts.shape[0], max_pts,
                                              replace=False)
        pts = pts[sel]
    c = pts[:, 3] if (show_intensity and pts.shape[1] > 3) else pts[:, 2]
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=point_size, c=c,
               cmap="viridis", linewidths=0)
    return fig


def draw_corners3d(corners3d, fig, color=(1, 1, 1), line_width=1.2,
                   cls=None, max_num=500):
    """corners3d (N, 8, 3): batched 12-edge wireframes via one
    Line3DCollection; optional score/label text at corner 6 (the
    reference's tag corner, pyplot_vis_utils.py:213-239)."""
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    ax = fig.gca()
    corners3d = _as_np(corners3d)
    num = min(max_num, len(corners3d))
    if num == 0:
        return fig
    segs = []
    for n in range(num):
        b = corners3d[n]
        segs.extend([(b[i], b[j]) for i, j in _EDGES])
    ax.add_collection3d(
        Line3DCollection(segs, colors=[color], linewidths=line_width))
    if cls is not None:
        cls = _as_np(cls)
        for n in range(num):
            b = corners3d[n]
            txt = f"{cls[n]:.2f}" if np.issubdtype(
                np.asarray(cls[n]).dtype, np.floating) else str(cls[n])
            ax.text(b[6, 0], b[6, 1], b[6, 2], txt, color=color, fontsize=6)
    return fig


def draw_multi_grid_range(fig, grid_size=20, bv_range=(-60, -60, 60, 60),
                          z=0.0, color=(0.35, 0.35, 0.35)):
    """Ground-plane grid at height z (pyplot_vis_utils.py:160-179)."""
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    ax = fig.gca()
    x0, y0, x1, y1 = bv_range
    segs = []
    for x in range(int(x0), int(x1) + 1, grid_size):
        segs.append(((x, y0, z), (x, y1, z)))
    for y in range(int(y0), int(y1) + 1, grid_size):
        segs.append(((x0, y, z), (x1, y, z)))
    ax.add_collection3d(
        Line3DCollection(segs, colors=[color], linewidths=0.4))
    return fig


def draw_scenes(points, gt_boxes=None, ref_boxes=None, ref_scores=None,
                ref_labels=None, bv_range=(-60, -60, 60, 60),
                view=(45.0, -60.0)):
    """Reference draw_scenes contract (pyplot_vis_utils.py:182-210 /
    open3d_vis_utils.py): GT boxes blue, predictions colored per label
    (score text), over the 3D point cloud + ground grid. Returns the
    matplotlib figure."""
    points = _as_np(points)
    gt_boxes = _as_np(gt_boxes)
    ref_boxes = _as_np(ref_boxes)
    ref_scores = _as_np(ref_scores)
    ref_labels = _as_np(ref_labels)

    fig = visualize_pts(points)
    fig = draw_multi_grid_range(fig, bv_range=bv_range)
    if gt_boxes is not None and len(gt_boxes) > 0:
        corners = boxes_to_corners_3d(gt_boxes[:, :7])
        fig = draw_corners3d(corners, fig, color=(0.2, 0.4, 1.0),
                             max_num=100)
    if ref_boxes is not None and len(ref_boxes) > 0:
        corners = boxes_to_corners_3d(ref_boxes[:, :7])
        if ref_labels is None:
            fig = draw_corners3d(corners, fig, color=(0, 1, 0),
                                 cls=ref_scores, max_num=100)
        else:
            for k in range(int(ref_labels.min()), int(ref_labels.max()) + 1):
                mask = ref_labels == k
                if not mask.any():
                    continue
                color = box_colormap[k % len(box_colormap)]
                fig = draw_corners3d(
                    corners[mask], fig, color=color,
                    cls=ref_scores[mask] if ref_scores is not None else None,
                    max_num=100)
    ax = fig.gca()
    ax.set_xlim(bv_range[0], bv_range[2])
    ax.set_ylim(bv_range[1], bv_range[3])
    ax.set_zlim(-3, 10)
    try:  # equal aspect where supported (matplotlib >= 3.6)
        ax.set_box_aspect((bv_range[2] - bv_range[0],
                           bv_range[3] - bv_range[1], 13))
    except Exception:
        pass
    ax.view_init(elev=view[0], azim=view[1])
    return fig


def save_scene(out_path, points, gt_boxes=None, ref_boxes=None,
               ref_scores=None, ref_labels=None, dpi=120, **kw):
    """Headless render-to-PNG (tools/demo_pyplot.py's savefig flow)."""
    import matplotlib.pyplot as plt

    fig = draw_scenes(points, gt_boxes, ref_boxes, ref_scores, ref_labels,
                      **kw)
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight",
                facecolor=fig.get_facecolor())
    plt.close(fig)
    return Path(out_path)
