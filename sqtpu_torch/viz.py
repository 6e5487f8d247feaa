"""Diagnostics: the loss landscape along a rotation, depth and voxel plots,
the fit's playback, gradient flow, loss curves and turntable renders.

Counterpart of ``sqtpu/viz.py``: every function has its name, arguments,
return values and files. matplotlib is imported only inside :func:`_plt`,
so this module imports on a host without it; only the drawing needs it.
Each plotting function takes its numbers from a plain helper that needs no
matplotlib and runs where its tensors lie (the kernels on the card):

* :func:`slerp_sweep` (:func:`sweep_numbers`) — the loss and IoU as the
  predicted quaternion moves along slerp(q_start → q_end), one batch of
  the ``n`` rotations: the explicit loss is K5 over the full lattice, the
  implicit loss K1 over the full sweep, per sample, on the card;
* :func:`turntable` (:func:`turntable_views`) — depth renders from
  ``n_views`` cameras about an axis, one (V, 12) batch through K3;
* :func:`fit_view` and :func:`fit_animation` (:func:`fit_frames`) — the
  gradient-descent fit in segments (:func:`sqtpu_torch.fit.gd_fit`: K4, or
  K1/K2 with the implicit loss, over the full lattice);
* :func:`plot_grad_flow` (:func:`grad_flow`), :func:`plot_history`
  (:func:`read_history`), :func:`voxel_scatter` (:func:`voxel_field`),
  :func:`depth_grid` and :func:`plot_points`.

In place of the JAX package's ``key``, :func:`fit_view` and
:func:`fit_animation` take the fit's start ``p0`` (None: the start of
:func:`sqtpu_torch.fit.draw_truth_and_start`), and a ``target_image`` for
the image losses (None: the fit CLI's K3 image of ``target_params``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import torch

from sqtpu_torch.ops import geometry, losses, metrics
from sqtpu_torch.ops import quaternion as quat

PLOT_RENDER_MODES = ("all", "in", "in_inv", "bit", "shell")


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    return plt


def _np(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# The loss landscape along a rotation (torch/classes.py:478-608)
# ---------------------------------------------------------------------------

def sweep_numbers(base_params: torch.Tensor, q_start: torch.Tensor,
                  q_end: torch.Tensor, loss_name: str = "explicit",
                  n: int = 200, render_size: int = 32):
    """The numbers of :func:`slerp_sweep`, as (n,) tensors on the params'
    device: (angles in radians, losses, IoUs). The predictions are
    ``base_params`` with the quaternion ``slerp(q_start, q_end, t)``, t on
    linspace(0, 1, n), scored against ``base_params`` in one batch."""
    from sqtpu_torch.ops.kernels import explicit_loss_auto, implicit_loss_auto
    from sqtpu_torch.ops.render import render_depth_soft

    if loss_name not in ("explicit", "implicit", "quaternion"):
        raise ValueError(loss_name)
    t = geometry.make_axis(n, "iou", dtype=base_params.dtype,
                           device=base_params.device)
    qs = quat.slerp(q_start, q_end, t)  # (n, 4)
    true_p = base_params[None].expand(n, -1)
    pred = torch.cat([true_p[:, :8], qs], dim=-1)
    q_true = base_params[geometry.QUAT_SLICE]
    with torch.no_grad():
        if loss_name == "explicit":
            ls = explicit_loss_auto(true_p, pred, render_size, reduce=False,
                                    z_window=False)
        elif loss_name == "implicit":  # the target is rendered once
            target = render_depth_soft(base_params, render_size)
            ls = implicit_loss_auto(target.expand(n, -1, -1).contiguous(),
                                    pred, render_size, z_window=False,
                                    reduce=False)
        else:
            ls = losses.quaternion_loss(qs, q_true[None], reduce=False)
        ious = metrics.iou(true_p, pred, render_size, reduce=False)
        angs = metrics.angle_error(q_true[None], qs)
    return angs, ls, ious


def slerp_sweep(base_params: torch.Tensor, q_start: torch.Tensor,
                q_end: torch.Tensor, loss_name: str = "explicit",
                n: int = 200, render_size: int = 32,
                out_png: str | None = None):
    """Sweep the predicted quaternion along slerp(q_start → q_end) and
    measure the loss and IoU against the fixed true params. Returns numpy
    (angles_rad, losses, ious); optionally saves the twin-axis plot of
    ``classes.py:584-602``."""
    angs, ls, ious = (_np(v) for v in sweep_numbers(
        base_params, q_start, q_end, loss_name, n, render_size))
    if out_png:
        plt = _plt()
        fig, ax1 = plt.subplots()
        ax1.set_xlabel("Angle (deg)")
        ax1.set_ylabel("Loss", color="tab:red")
        ax1.plot(np.rad2deg(angs), ls, color="tab:red")
        ax2 = ax1.twinx()
        ax2.set_ylabel("Accuracy", color="tab:blue")
        ax2.plot(np.rad2deg(angs), ious, color="tab:blue")
        fig.tight_layout()
        fig.savefig(out_png, dpi=120)
        plt.close(fig)
    return angs, ls, ious


# ---------------------------------------------------------------------------
# Depth and voxel plots (helpers.py:71-185)
# ---------------------------------------------------------------------------

def depth_grid(true_imgs, pred_imgs, out_png: str, max_n: int = 8):
    """Side-by-side true|pred depth pairs, one row per sample."""
    plt = _plt()
    n = min(len(true_imgs), max_n)
    fig, axes = plt.subplots(n, 2, figsize=(6, 3 * n), squeeze=False)
    for i in range(n):
        axes[i][0].imshow(_np(true_imgs[i]), cmap="gray", vmin=0, vmax=1)
        axes[i][0].set_title("true")
        axes[i][1].imshow(_np(pred_imgs[i]), cmap="gray", vmin=0, vmax=1)
        axes[i][1].set_title("pred")
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_png, dpi=100)
    plt.close(fig)


def voxel_field(p: torch.Tensor, n: int = 24):
    """F^e1 of ``p`` (12,) on the IoU's n³ grid of [0, 1]³, unguarded, and
    the grid's coordinates: numpy (f, (X, Y, Z)), each (n, n, n)."""
    ax1d = geometry.make_axis(n, "iou", dtype=p.dtype, device=p.device)
    f = _np(geometry.field_grid(ax1d, ax1d, ax1d, p, guard=False))
    ax = _np(ax1d)
    return f, np.meshgrid(ax, ax, ax, indexing="ij")


def voxel_scatter(p: torch.Tensor, out_png: str, n: int = 24,
                  mode: str = "in", eps: float = 0.1):
    """3-D scatter of the voxelized field in the five ``plot_render``
    display modes of the reference (``helpers.py:117-133``): ``"all"``
    every voxel, ``"in"`` F ≤ 1 (the rest faint), ``"in_inv"`` F > 0.9
    (the rest faint), ``"bit"`` the binarized occupancy, ``"shell"``
    |F − 1| < eps."""
    if mode not in PLOT_RENDER_MODES:
        raise ValueError(f"mode {mode!r} not in {PLOT_RENDER_MODES}")
    plt = _plt()
    f, g = voxel_field(p, n)
    if mode == "all":
        disp, opacity = f >= 0, 0.0
    elif mode == "in":
        disp, opacity = f <= 1, 0.2
    elif mode == "in_inv":
        disp, opacity = f > 0.9, 0.2
    elif mode == "bit":
        f = (f <= 1).astype(np.float32)
        disp, opacity = f == 1, 0.0
    else:  # shell
        disp, opacity = (f < 1 + eps) & (f > 1 - eps), 0.0
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.scatter(g[0][disp], g[1][disp], g[2][disp], c=f[disp], cmap="jet",
               marker="o", s=4)
    if opacity > 0:
        hid = ~disp
        ax.scatter(g[0][hid], g[1][hid], g[2][hid], c=f[hid], cmap="jet",
                   marker="o", s=2, alpha=opacity)
    ax.set(xlim=(0, 1), ylim=(0, 1), zlim=(0, 1))
    fig.savefig(out_png, dpi=100)
    plt.close(fig)


def plot_points(points, out_png: str, lims=(-1.0, 1.0)):
    """3-D scatter of (N, 3) points (``helpers.py:176-185``), e.g. a
    depth image's lift or :func:`geometry.sample_surface`."""
    plt = _plt()
    pts = _np(points)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], marker="o")
    ax.set(xlim=lims, ylim=lims, zlim=lims)
    ax.set_xlabel("X Axis")
    ax.set_ylabel("Y Axis")
    ax.set_zlabel("Z Axis")
    fig.savefig(out_png, dpi=100)
    plt.close(fig)


# ---------------------------------------------------------------------------
# The fit's playback (torch/visu.py:96-209)
# ---------------------------------------------------------------------------

def fit_frames(cfg, target_params: torch.Tensor, n_frames: int = 6,
               p0: torch.Tensor | None = None, target_image=None):
    """The numbers of :func:`fit_view` and :func:`fit_animation`: ``cfg``'s
    fit run in ``n_frames`` segments of max(cfg.steps // n_frames, 1)
    steps, each from the last one's end with a fresh optimizer state.
    Returns (the params after each segment, (12,) tensors; each segment's
    last loss, floats; the steps of a segment)."""
    from sqtpu_torch.fit import gd_fit
    from sqtpu_torch.ops.kernels import render_hard_auto

    seg = dataclasses.replace(cfg, steps=max(cfg.steps // n_frames, 1))
    if target_image is None and cfg.loss != "explicit":
        # the fit CLI's image of the truth
        target_image = render_hard_auto(target_params[None], 256,
                                        n_sweep=256, n_bisect=12,
                                        quantize=True)[0]
    p, frames, last = p0, [], []
    for _ in range(n_frames):
        p, hist = gd_fit(seg, target_params=target_params,
                         target_image=target_image, p0=p)
        p = p.detach()
        frames.append(p)
        last.append(float(hist[-1]))
    return frames, last, seg.steps


def _fit_panel(ax, true_pts, fit_pts):
    ax.scatter(true_pts[:, 0], true_pts[:, 1], true_pts[:, 2], s=2,
               c="lightgray")
    ax.scatter(fit_pts[:, 0], fit_pts[:, 1], fit_pts[:, 2], s=2,
               c=fit_pts[:, 2], cmap="jet")
    ax.set(xlim=(0, 1), ylim=(0, 1), zlim=(0, 1))


def fit_view(cfg, target_params: torch.Tensor, out_png: str,
             n_frames: int = 6, p0: torch.Tensor | None = None,
             target_image=None):
    """Headless counterpart of ``visu.py``'s live fitting window
    (``visu.py:123-192``): the fit in segments (:func:`fit_frames`), one
    panel per segment, the true surface (gray) against the current fit
    (colored), the loss in the title. Returns the per-frame params (numpy
    (12,) each)."""
    frames, last, steps = fit_frames(cfg, target_params, n_frames, p0,
                                     target_image)
    plt = _plt()
    true_pts = _np(geometry.sample_surface(target_params, 32, 16))
    fig, axes = plt.subplots(1, n_frames, figsize=(3 * n_frames, 3),
                             subplot_kw={"projection": "3d"},
                             squeeze=False)
    for i, (pf, ax) in enumerate(zip(frames, axes[0])):
        _fit_panel(ax, true_pts, _np(geometry.sample_surface(pf, 32, 16)))
        ax.set_title(f"step {(i + 1) * steps}\nloss {last[i]:.4f}",
                     fontsize=7)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    return [_np(pf) for pf in frames]


def fit_animation(cfg, target_params: torch.Tensor, out_html: str,
                  n_frames: int = 24, p0: torch.Tensor | None = None,
                  target_image=None):
    """Per-segment playback of the fit (``torch/visu.py:96-141,189-192``'s
    live window, headless): one 3-D snapshot per segment of
    :func:`fit_frames`, embedded as base64 PNGs in a self-contained HTML
    file with play/pause and a step slider. Returns each segment's last
    loss."""
    import base64
    import io

    frames, last, steps = fit_frames(cfg, target_params, n_frames, p0,
                                     target_image)
    plt = _plt()
    true_pts = _np(geometry.sample_surface(target_params, 32, 16))
    frames_b64 = []
    for i, pf in enumerate(frames):
        fig = plt.figure(figsize=(4, 4))
        ax = fig.add_subplot(projection="3d")
        _fit_panel(ax, true_pts, _np(geometry.sample_surface(pf, 32, 16)))
        ax.set_title(f"step {(i + 1) * steps}   loss {last[i]:.5f}",
                     fontsize=9)
        ax.axis("off")
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=90)
        plt.close(fig)
        frames_b64.append(base64.b64encode(buf.getvalue()).decode())

    imgs_js = ",".join(f'"{b}"' for b in frames_b64)
    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>sqtpu fit playback</title></head>
<body style="font-family:sans-serif;text-align:center">
<h3>Gradient-descent SQ fit ({cfg.loss} loss, {cfg.steps} steps)</h3>
<img id="f" style="max-width:480px"><br>
<button onclick="toggle()" id="b">pause</button>
<input type="range" id="s" min="0" max="{n_frames - 1}" value="0"
 oninput="show(+this.value)" style="width:360px">
<span id="t"></span>
<script>
const imgs = [{imgs_js}];
let i = 0, playing = true;
function show(j) {{
  i = j;
  document.getElementById('f').src = 'data:image/png;base64,' + imgs[i];
  document.getElementById('s').value = i;
  document.getElementById('t').textContent = (i + 1) + '/' + imgs.length;
}}
function toggle() {{
  playing = !playing;
  document.getElementById('b').textContent = playing ? 'pause' : 'play';
}}
setInterval(() => {{ if (playing) show((i + 1) % imgs.length); }}, 250);
show(0);
</script></body></html>"""
    with open(out_html, "w") as f:
        f.write(html)
    return last


# ---------------------------------------------------------------------------
# Gradient flow and loss curves (helpers.py:242-268, torch/helpers.py:323)
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=()):
    """(path, tensor) leaves of a nested dict, keys in sorted order (the
    JAX package's pytree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def grad_flow(grads):
    """The numbers of :func:`plot_grad_flow`: (names, mean |grad|s,
    max |grad|s) per tensor, bias tensors skipped. ``grads`` is a nested
    dict of tensors (names: the keys joined by ``/``) or a module whose
    parameters hold gradients (``named_parameters``' names, ``.`` as
    ``/``)."""
    if isinstance(grads, torch.nn.Module):
        leaves = [(tuple(n.split(".")), p.grad)
                  for n, p in grads.named_parameters() if p.grad is not None]
    else:
        leaves = list(_flatten(grads))
    names, means, maxs = [], [], []
    for path, leaf in leaves:
        name = "/".join(path)
        if "bias" in name:
            continue
        a = np.abs(_np(leaf))
        names.append(name)
        means.append(a.mean())
        maxs.append(a.max())
    return names, means, maxs


def plot_grad_flow(grads, out_png: str):
    """Mean and max |grad| per tensor (``helpers.py:242-268``) as bars on
    a log scale; returns :func:`grad_flow`'s (names, means, maxs)."""
    names, means, maxs = grad_flow(grads)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.3), 4))
    ax.bar(range(len(maxs)), maxs, alpha=0.3, color="c", label="max")
    ax.bar(range(len(means)), means, alpha=0.5, color="b", label="mean")
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation="vertical", fontsize=5)
    ax.set_ylabel("|gradient|")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return names, means, maxs


def read_history(ckpt_or_jsonl: str) -> dict:
    """The loss history of a trainer's ``--ckpt-dir`` (the ``history`` of
    ``last.meta.json``, else ``best.meta.json``) or of a
    ``*_metrics.jsonl`` log (every numeric key but ``epoch``, in order)."""
    if os.path.isdir(ckpt_or_jsonl):
        for name in ("last.meta.json", "best.meta.json"):
            cand = os.path.join(ckpt_or_jsonl, name)
            if os.path.exists(cand):
                with open(cand) as f:
                    return json.load(f)["history"]
        raise FileNotFoundError(
            f"no last/best.meta.json under {ckpt_or_jsonl}")
    history = {}
    with open(ckpt_or_jsonl) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if isinstance(v, (int, float)) and k != "epoch":
                    history.setdefault(k, []).append(v)
    return history


def plot_history(ckpt_or_jsonl: str, out_png: str):
    """Loss and metric curves of a checkpoint directory or a metrics JSONL
    (:func:`read_history`; ``torch/helpers.py:323-327`` plots a
    checkpoint's stored history). Returns the history dict."""
    history = read_history(ckpt_or_jsonl)
    plt = _plt()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    for k in sorted(history):
        vals = np.asarray(history[k], dtype=np.float64)
        if "loss" in k and np.isfinite(vals).any():
            ax1.plot(vals, label=k)
        elif ("acc" in k or "angle" in k) and np.isfinite(vals).any():
            ax2.plot(vals, label=k)
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("loss")
    ax1.set_yscale("log")
    ax1.legend(fontsize=8)
    ax2.set_xlabel("epoch")
    ax2.set_ylabel("metric")
    ax2.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return history


# ---------------------------------------------------------------------------
# Turntable renders
# ---------------------------------------------------------------------------

def turntable_cameras(n_views: int = 8, axis=(0.0, 1.0, 0.0),
                      dtype=torch.float32, device=None):
    """The turntable's angles i·2π/n_views and its (V, 4) cameras, turned
    by them about ``axis`` (world-from-camera quaternions)."""
    ax = torch.as_tensor(axis, dtype=dtype, device=device)
    ax = ax / torch.linalg.vector_norm(ax)
    angles = torch.from_numpy(np.linspace(
        0.0, 2.0 * math.pi, n_views, endpoint=False)).to(device, dtype)
    return angles, torch.cat([ax * torch.sin(angles / 2)[:, None],
                              torch.cos(angles / 2)[:, None]], dim=-1)


def turntable_views(p: torch.Tensor, n_views: int = 8,
                    image_size: int = 128, axis=(0.0, 1.0, 0.0)):
    """The numbers of :func:`turntable`: the angles in the params' dtype
    and the (V, S, S) depth maps of ``p`` (12,) from
    :func:`turntable_cameras`, rendered as one batch by
    :func:`sqtpu_torch.ops.render.render_depth_view` (K3 on the card;
    n_bisect 24, unquantized, ``image_size`` slabs)."""
    from sqtpu_torch.ops.render import render_depth_view

    angles, cam_qs = turntable_cameras(n_views, axis, p.dtype, p.device)
    return angles, render_depth_view(p, cam_qs, image_size)


def turntable(p: torch.Tensor, out_png: str, n_views: int = 8,
              image_size: int = 128, axis=(0.0, 1.0, 0.0)):
    """A grid of depth renders from ``n_views`` cameras spinning about
    ``axis`` (default y: the viewer looks along −z, so a y-spin walks
    around the object), :func:`turntable_views`. Returns the numpy
    (n, S, S) stack and saves the panel."""
    angles, views = turntable_views(p, n_views, image_size, axis)
    angles, views = _np(angles), _np(views)
    plt = _plt()
    cols = min(4, n_views)
    rows = -(-n_views // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    for i, a in enumerate(np.atleast_1d(axes).ravel()):
        if i < n_views:
            a.imshow(views[i], cmap="gray", vmin=0, vmax=1)
            a.set_title(f"{float(angles[i]) * 180 / 3.14159:.0f}°",
                        fontsize=8)
        a.axis("off")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return views
