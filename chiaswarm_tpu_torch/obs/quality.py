"""Image-quality metrics for the step-collapse gates, a copy of
``chiaswarm_tpu/obs/quality.py``: PSNR, SSIM over a uniform box window
(integral-image means and variances), and :func:`quality_report`, the gate
at 30 dB and 0.9 that DeepCache's feature reuse is held to against its
full-compute twin. Pure numpy on host images, so the gate runs the same on
any host.
"""

from __future__ import annotations

import numpy as np


def _as_float(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    return img.astype(np.float64)


def psnr(a: np.ndarray, b: np.ndarray, *, data_range: float = 255.0,
         ) -> float:
    """Peak signal-to-noise ratio in dB over the whole array pair.

    Identical inputs return ``inf``. Shapes must match — a silent
    broadcast would gate the wrong pixels."""
    a, b = _as_float(a), _as_float(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _box_mean(img: np.ndarray, win: int) -> np.ndarray:
    """(H, W) local means over a win x win box for every valid window
    position, via an integral image — O(HW), no dependencies."""
    pad = np.zeros((img.shape[0] + 1, img.shape[1] + 1), np.float64)
    np.cumsum(np.cumsum(img, axis=0), axis=1, out=pad[1:, 1:])
    s = (pad[win:, win:] - pad[:-win, win:]
         - pad[win:, :-win] + pad[:-win, :-win])
    return s / (win * win)


def ssim(a: np.ndarray, b: np.ndarray, *, data_range: float = 255.0,
         win: int = 7) -> float:
    """Mean structural similarity over all channels (uniform window).

    Accepts (H, W), (H, W, C) or (B, H, W, C); channels and batch
    members are scored independently and averaged."""
    a, b = _as_float(a), _as_float(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    if a.ndim == 3:
        a, b = a[None], b[None]
    if a.shape[1] < win or a.shape[2] < win:
        raise ValueError(f"images smaller than the {win}x{win} window")
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    scores = []
    for bi in range(a.shape[0]):
        for ch in range(a.shape[-1]):
            x, y = a[bi, :, :, ch], b[bi, :, :, ch]
            mx, my = _box_mean(x, win), _box_mean(y, win)
            mxx = _box_mean(x * x, win) - mx * mx
            myy = _box_mean(y * y, win) - my * my
            mxy = _box_mean(x * y, win) - mx * my
            num = (2 * mx * my + c1) * (2 * mxy + c2)
            den = (mx ** 2 + my ** 2 + c1) * (mxx + myy + c2)
            scores.append(np.mean(num / den))
    return float(np.mean(scores))


def quality_report(test: np.ndarray, reference: np.ndarray, *,
                   psnr_floor: float = 30.0,
                   ssim_floor: float = 0.9) -> dict:
    """The step-collapse quality gate as one stampable dict: PSNR/SSIM
    of ``test`` against ``reference`` plus the pass verdicts at the
    shipped floors (reports stamp it; tests assert ``passed``)."""
    p = psnr(test, reference)
    s = ssim(test, reference)
    return {
        # bit-identical inputs: null, not inf — a report must stay
        # strict-JSON parseable (json.dumps prints inf as bare
        # 'Infinity', which jq/JSON.parse reject)
        "psnr_db": round(p, 2) if np.isfinite(p) else None,
        "ssim": round(s, 4),
        "psnr_floor_db": psnr_floor,
        "ssim_floor": ssim_floor,
        "passed": bool(p >= psnr_floor and s >= ssim_floor),
    }
