"""OpenCV's HDR calibration, merge and tonemaps (its ``photo`` module) in
numpy, so that the port's HDR-merged frames need no cv2 (the card's machine
has none).

Each function takes and returns what the cv2 object's ``process`` does:
a list of uint8 ``[H, W, 3]`` exposures, their float32 exposure times, a
float32 ``[256, 1, 3]`` camera response, a float32 ``[H, W, 3]`` radiance
map. The arithmetic is float32 in cv2's order where that order decides a
result:

- ``calibrate_robertson`` / ``merge_robertson``: the response starts
  linear with level 128 at 1, the per-level pixel counts divide the
  per-level sums (a level that no pixel takes gets 0 * inf = NaN, as in
  cv2, so the stopping rule's mean absolute change is NaN and all
  ``max_iter`` iterations run), every iteration renormalises to level 128;
  the merge is ``sum(w t E) / (sum(w t^2) + DBL_EPSILON)``, whose Gaussian
  weight is 0 at levels 0 and 255, so a pixel at 0 or 255 in every
  exposure merges to 0, not NaN.
- ``calibrate_debevec`` / ``merge_debevec``: the grid of
  ``x_points * y_points`` sample points (not ``samples`` of them), the
  triangle weights (``i`` below 128, ``255 - i`` above; the merge adds
  1e-6 to each, so a pixel at 0 or 255 everywhere gets the unweighted
  mean), the row that pins level 128 to log 1 and the ``lambda``
  smoothness rows. This solves the system with LAPACK in float64
  (``np.linalg.lstsq``), the least-squares answer. cv2 solves it in
  float32 through its own OpenBLAS, and its answer has a larger residual
  and changes with that library's thread count
  (``port_tools/debevec_solver_probe.py``), so no copy can give cv2's
  bits: the responses differ by a few % (``tests/test_torch_hdr.py``),
  most where only the smoothness rows or the level-128 row hold the
  curve.
- the tonemaps: cv2's linear stretch (``fma(x, f32(1/d), f32(-min/d))``
  with ``d = f32(max - min)``, min and max ignoring NaN unless the first
  value is NaN, then no stretch), ``COLOR_RGB2GRAY``, ``log(max(x,
  1e-4))``, and ``mapLuminance``, which divides each channel by the
  luminance, so a pixel whose luminance is 0 becomes 0 / 0 = NaN under
  Mantiuk and Drago (Reinhard divides by ``adapt + c`` and gives 0). Mantiuk
  builds its contrast pyramid with ``resize`` (INTER_LINEAR; the exact
  halving is INTER_AREA) and solves with cv2's conjugate gradient. cv2's
  own log, exp and pow round differently from numpy's in the last bit,
  so values agree to about 1e-6, and a value that one rounding puts just
  below 0 before the last ``pow(x, 1 / gamma)`` (the darkest value after
  a Debevec merge) can be NaN on one side only.

Where cv2 fails an assertion (Drago's ``max > 0``, Mantiuk's ``fabs(dprod)
> 0``: a radiance map that is NaN, or constant) these raise ``ValueError``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

LDR_SIZE = 256
_f32 = np.float32
_f64 = np.float64
_DBL_EPSILON = np.finfo(np.float64).eps


# ----------------------------------------------------------------------
# shared pieces (cv2's hdr_common.cpp)

def _robertson_weights() -> np.ndarray:
    """The Gaussian weight curve [256] of Robertson's method: 0 at levels
    0 and 255, 1 in the middle."""
    q = _f32((LDR_SIZE - 1) / 4.0)
    e4 = _f32(np.exp(_f32(4.0)))
    scale = _f32(e4 / (e4 - _f32(1)))
    shift = _f32(_f32(1) / (_f32(1) - e4))
    v = np.arange(LDR_SIZE, dtype=_f32) / q - _f32(2)
    return (scale * np.exp(-v * v) + shift).astype(_f32)


def _triangle_weights() -> np.ndarray:
    """The hat [256] of Debevec's method: i below 128, 255 - i above."""
    i = np.arange(LDR_SIZE)
    return np.where(i < LDR_SIZE // 2, i, LDR_SIZE - 1 - i).astype(_f32)


def _inputs(images, times) -> Tuple[List[np.ndarray], np.ndarray]:
    images = [np.asarray(im) for im in images]
    times = np.asarray(times, _f32).reshape(-1)
    if not images:
        raise ValueError("no exposures")
    if len(images) != times.size:
        raise ValueError(f"{len(images)} exposures but {times.size} times")
    for im in images:
        if im.dtype != np.uint8:
            raise ValueError(f"exposures must be uint8, got {im.dtype}")
        if im.shape != images[0].shape or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError("exposures must be [H, W, 3] of one shape")
    return images, times


def _linear_response() -> np.ndarray:
    return np.repeat(np.arange(LDR_SIZE, dtype=_f32)[:, None], 3, 1)


def _response(response) -> np.ndarray:
    r = np.asarray(response, _f32)
    if r.size != LDR_SIZE * 3:
        raise ValueError(f"response must be [256, 1, 3], got {r.shape}")
    return r.reshape(LDR_SIZE, 3)


# ----------------------------------------------------------------------
# Robertson

def merge_robertson(images: Sequence[np.ndarray], times,
                    response: Optional[np.ndarray] = None) -> np.ndarray:
    """cv2.createMergeRobertson().process(images, times, response):
    ``sum_i t_i w(z) E(z) / (sum_i t_i^2 w(z) + DBL_EPSILON)`` per channel
    (response None: linear, level 128 at 1)."""
    images, times = _inputs(images, times)
    resp = (_linear_response() / _f32(LDR_SIZE / 2.0) if response is None
            else _response(response))
    return _merge_robertson(images, times, resp)


def _merge_robertson(images, times, resp) -> np.ndarray:
    w = _robertson_weights()
    ch = np.arange(3)
    result = np.zeros(images[0].shape, _f32)
    wsum = np.zeros(images[0].shape, _f32)
    for im, t in zip(images, times):
        wi = w[im]
        result += (t * wi) * resp[im, ch]
        wsum += (t * t) * wi
    return result * (_f32(1) / (wsum + _f32(_DBL_EPSILON)))


def calibrate_robertson(images: Sequence[np.ndarray], times,
                        max_iter: int = 30,
                        threshold: float = 0.01) -> np.ndarray:
    """cv2.createCalibrateRobertson(max_iter, threshold).process(images,
    times) -> the response [256, 1, 3]. Levels no pixel takes are NaN."""
    images, times = _inputs(images, times)
    resp = _linear_response() / _f32(LDR_SIZE / 2.0)
    card = np.zeros((LDR_SIZE, 3), _f32)
    for im in images:
        for c in range(3):
            card[:, c] += np.bincount(im[..., c].reshape(-1),
                                      minlength=LDR_SIZE)
    with np.errstate(divide="ignore"):
        card = _f32(1) / card
    flat = [[im[..., c].reshape(-1) for c in range(3)] for im in images]
    for _ in range(max_iter):
        rad = _merge_robertson(images, times, resp)
        new = np.zeros((LDR_SIZE, 3), _f32)
        for levels, t in zip(flat, times):
            for c in range(3):
                # cv2 adds pixel by pixel in f32; np.add.at is sequential
                np.add.at(new[:, c], levels[c],
                          t * rad[..., c].reshape(-1))
        with np.errstate(invalid="ignore", divide="ignore"):
            new = new * card
            new = new / new[LDR_SIZE // 2]
        diff = _f32(np.abs(new - resp).astype(_f64).sum() / 3)
        resp = new
        if diff < threshold:
            break
    return resp[:, None, :]


# ----------------------------------------------------------------------
# Debevec

def _debevec_points(rows: int, cols: int, samples: int,
                    random: bool) -> List[Tuple[int, int]]:
    if random:
        # cv2 draws with C's rand(); any uniform draw serves the method
        rng = np.random.default_rng()
        return [(int(rng.integers(cols)), int(rng.integers(rows)))
                for _ in range(samples)]
    x_points = int(np.sqrt(float(samples) * cols / rows))
    if not 0 < x_points <= cols:
        raise ValueError(f"{samples} samples do not fit {rows}x{cols}")
    y_points = samples // x_points
    if not 0 < y_points <= rows:
        raise ValueError(f"{samples} samples do not fit {rows}x{cols}")
    step_x, step_y = cols // x_points, rows // y_points
    points = []
    for i in range(x_points):
        x = step_x // 2 + i * step_x
        for j in range(y_points):
            y = step_y // 2 + j * step_y
            if 0 <= x < cols and 0 <= y < rows:
                points.append((x, y))
    return points


def calibrate_debevec(images: Sequence[np.ndarray], times,
                      samples: int = 70, lambda_: float = 10.0,
                      random: bool = False) -> np.ndarray:
    """cv2.createCalibrateDebevec(samples, lambda_, random).process(images,
    times) -> the response [256, 1, 3]: per channel, the least-squares g
    with ``w(z) (g(z) - ln E_i - ln t_j) = 0`` at each sample point and
    exposure, ``g(128) = 0`` and ``lambda w(z) g''(z) = 0``; returns
    ``exp(g)``. Solved in float64 (cv2: float32 SVD)."""
    images, times = _inputs(images, times)
    rows, cols = images[0].shape[:2]
    points = _debevec_points(rows, cols, samples, random)
    w = _triangle_weights()
    n, n_img = len(points), len(images)
    log_t = np.log(times).astype(_f32)
    px = np.array([p[0] for p in points], np.int64)
    py = np.array([p[1] for p in points], np.int64)
    lam = _f32(lambda_)
    out = np.empty((LDR_SIZE, 3), _f32)
    k = np.arange(n * n_img)
    for ch in range(3):
        a = np.zeros((n * n_img + LDR_SIZE + 1, LDR_SIZE + n), _f32)
        b = np.zeros(a.shape[0], _f32)
        # data rows, point-major: row i * n_img + j
        vals = np.stack([im[py, px, ch] for im in images], 1).reshape(-1)
        wij = w[vals]
        a[k, vals] = wij
        a[k, LDR_SIZE + k // n_img] = -wij
        b[k] = wij * np.tile(log_t, n)
        r = n * n_img
        a[r, LDR_SIZE // 2] = 1
        i = np.arange(LDR_SIZE - 2)
        wi = w[i + 1]
        a[r + 1 + i, i] = lam * wi
        a[r + 1 + i, i + 1] = _f32(-2) * lam * wi
        a[r + 1 + i, i + 2] = lam * wi
        sol = np.linalg.lstsq(a.astype(_f64), b.astype(_f64), rcond=None)[0]
        out[:, ch] = sol[:LDR_SIZE].astype(_f32)
    return np.exp(out).astype(_f32)[:, None, :]


def merge_debevec(images: Sequence[np.ndarray], times,
                  response: Optional[np.ndarray] = None) -> np.ndarray:
    """cv2.createMergeDebevec().process(images, times, response):
    ``exp(sum_i w_i (ln E(z) - ln t_i) / sum_i w_i)`` per channel, where
    ``w_i`` is the mean over the channels of the triangle weight (+1e-6) of
    the pixel's levels in exposure i (response None: linear, level 0 as
    level 1)."""
    images, times = _inputs(images, times)
    if response is None:
        resp = _linear_response()
        resp[0] = resp[1]
    else:
        resp = _response(response)
    with np.errstate(divide="ignore", invalid="ignore"):
        log_resp = np.log(resp).astype(_f32)
    log_t = np.log(times).astype(_f32)
    weights = (_triangle_weights() + _f32(1e-6)).astype(_f32)
    shape = images[0].shape
    result = np.zeros(shape, _f32)
    wsum = np.zeros(shape[:2], _f32)
    for im, lt in zip(images, log_t):
        w = np.zeros(shape[:2], _f32)
        for c in range(3):
            w += weights[im[..., c]]
        w /= _f32(3)
        for c in range(3):
            result[..., c] += w * (log_resp[im[..., c], c] - lt)
        wsum += w
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return np.exp(result * (_f32(1) / wsum)[..., None]).astype(_f32)


# ----------------------------------------------------------------------
# tonemaps (cv2's tonemap.cpp)

def _fma32(x: np.ndarray, a: np.float32, b: np.float32) -> np.ndarray:
    """fma(x, a, b) in float32, rounded once: x * a is exact in float64;
    the float64 sum's rounding error (two-sum) breaks the ties that a
    second rounding to float32 would get wrong."""
    p = x.astype(_f64) * _f64(a)
    s = p + _f64(b)
    bb = s - p
    err = (p - (s - bb)) + (_f64(b) - bb)
    f = s.astype(_f32)
    r = s - f.astype(_f64)
    with np.errstate(invalid="ignore"):
        other = np.nextafter(f, np.where(r > 0, np.inf, -np.inf)
                             .astype(_f32))
        tie = (r != 0) & (np.abs(r) == np.abs(other.astype(_f64) - s))
        return np.where(tie & (np.sign(err) == np.sign(r)), other, f)


def _pow(x: np.ndarray, power) -> np.ndarray:
    """cv2.pow(x, power) of a float32 array: an integral power by binary
    exponentiation in float32 (exact at 1), any other through numpy
    (NaN below 0)."""
    power = _f32(power)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        if power != np.floor(power):
            return np.power(x, power).astype(_f32)
        n, base, out = abs(int(power)), x.astype(_f32), None
        while n:
            if n & 1:
                out = base if out is None else (out * base).astype(_f32)
            n >>= 1
            if n:
                base = (base * base).astype(_f32)
        if out is None:
            return np.ones_like(x, _f32)
        return out if power > 0 else (_f32(1) / out).astype(_f32)


def _min_max(x: np.ndarray) -> Tuple[float, float]:
    """cv2.minMaxLoc: NaN is never taken, but the walk starts from the
    first value, so a NaN there is both the minimum and the maximum."""
    if np.isnan(x.reshape(-1)[0]):
        return _f64(np.nan), _f64(np.nan)
    with np.errstate(invalid="ignore"):
        return _f64(np.nanmin(x)), _f64(np.nanmax(x))


def _stretch(src: np.ndarray, gamma: float) -> np.ndarray:
    """cv2.createTonemap(gamma).process(src): (src - min) / (max - min) as
    cv2 rounds it, then ``pow(x, 1 / gamma)`` (NaN below 0)."""
    src = np.asarray(src, _f32)
    lo, hi = _min_max(src)
    if hi - lo > _DBL_EPSILON:
        d = _f64(_f32(hi - lo))
        dst = _fma32(src, _f32(1.0 / d), _f32(-lo / d))
    else:
        dst = src.copy()
    return _pow(dst, _f32(1.0) / _f32(gamma))


def _gray(img: np.ndarray) -> np.ndarray:
    """cvtColor(img, COLOR_RGB2GRAY) of a float image."""
    return (img[..., 0] * _f32(0.299) + img[..., 1] * _f32(0.587)
            + img[..., 2] * _f32(0.114)).astype(_f32)


def _log(x: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore"):
        return np.log(np.maximum(x, _f32(1e-4))).astype(_f32)


def _map_luminance(img, lum, new_lum, saturation) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        out = img * (_f32(1) / lum)[..., None]
        return (_pow(out, saturation) * new_lum[..., None]).astype(_f32)


def _hdr(hdr) -> np.ndarray:
    hdr = np.asarray(hdr)
    if hdr.ndim != 3 or hdr.shape[2] != 3 or hdr.dtype != np.float32:
        raise ValueError(f"expected a float32 [H, W, 3] radiance map, got "
                         f"{hdr.dtype} {hdr.shape}")
    return hdr


def tonemap_reinhard(hdr: np.ndarray, gamma: float = 2.2,
                     intensity: float = -1.0, light_adapt: float = 0.0,
                     color_adapt: float = 0.0) -> np.ndarray:
    """cv2.createTonemapReinhard(gamma, intensity, light_adapt,
    color_adapt).process(hdr) (the defaults: the JAX package's)."""
    img = _stretch(_hdr(hdr), 1.0)
    gray = _gray(img)
    log_img = _log(gray)
    log_mean = _f32(log_img.astype(_f64).sum() / log_img.size)
    log_min, log_max = _min_max(log_img)
    with np.errstate(divide="ignore", invalid="ignore"):
        key = _f32((log_max - _f64(log_mean)) / (log_max - log_min))
        map_key = _f32(0.3) + _f32(0.7) * np.power(key, _f32(1.4))
    inten = _f32(np.exp(-_f64(intensity)))
    chan_mean = img.astype(_f64).reshape(-1, 3).mean(0)
    gray_mean = _f32(gray.astype(_f64).mean())
    ca, la = _f32(color_adapt), _f32(light_adapt)
    out = np.empty_like(img)
    for i in range(3):
        c = img[..., i]
        glob = ca * _f32(chan_mean[i]) + (_f32(1) - ca) * gray_mean
        adapt = ca * c + (_f32(1) - ca) * gray
        adapt = la * adapt + (_f32(1) - la) * glob
        with np.errstate(divide="ignore", invalid="ignore"):
            adapt = _pow(inten * adapt, map_key)
            out[..., i] = c * (_f32(1) / (adapt + c))
    return _stretch(out, gamma)


def tonemap_drago(hdr: np.ndarray, gamma: float = 2.2,
                  saturation: float = 1.0, bias: float = 0.85) -> np.ndarray:
    """cv2.createTonemapDrago(gamma, saturation, bias).process(hdr)."""
    img = _stretch(_hdr(hdr), 1.0)
    gray = _gray(img)
    log_img = _log(gray)
    mean = _f32(np.exp(_f32(log_img.astype(_f64).sum()) / _f32(log_img.size)))
    gray = (gray / mean).astype(_f32)
    gmax = _min_max(gray)[1]
    if not gmax > 0:
        raise ValueError("tonemap_drago: the luminance has no maximum > 0 "
                         "(cv2: Assertion failed: max > 0)")
    new_lum = np.log(gray + _f32(1)).astype(_f32)
    div = _pow(gray / _f32(gmax), np.log(_f32(bias)) / np.log(_f32(0.5)))
    div = np.log(_f32(2) + _f32(8) * div).astype(_f32)
    new_lum = (new_lum * (_f32(1) / div)).astype(_f32)
    img = _map_luminance(img, gray, new_lum, saturation)
    return _stretch(img, gamma)


def _resize_linear(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(src, (width, height)) of a float32 [H, W] image with
    INTER_LINEAR (cv2 takes INTER_AREA for an exact halving)."""
    sh, sw = src.shape
    if sw == 2 * width and sh == 2 * height:
        return ((src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2]
                 + src[1::2, 1::2]) * _f32(0.25)).astype(_f32)

    def taps(dsize, ssize):
        f = ((np.arange(dsize) + 0.5) * (ssize / dsize) - 0.5).astype(_f32)
        s = np.floor(f).astype(np.int64)
        f = (f - s).astype(_f32)
        f[s < 0] = 0
        s[s < 0] = 0
        f[s >= ssize - 1] = 0
        s[s >= ssize - 1] = ssize - 1
        return s, np.minimum(s + 1, ssize - 1), (_f32(1) - f), f

    x0, x1, a0, a1 = taps(width, sw)
    y0, y1, b0, b1 = taps(height, sh)
    rows = (src[:, x0] * a0 + src[:, x1] * a1).astype(_f32)
    return (rows[y0] * b0[:, None] + rows[y1] * b1[:, None]).astype(_f32)


def _gradient(src: np.ndarray, pos: int) -> np.ndarray:
    dst = np.zeros_like(src)
    dst[:, pos:src.shape[1] + pos - 1] = src[:, 1:] - src[:, :-1]
    if pos == 1:
        dst[:, 0] = src[:, 0]
    return dst


def _contrast(src: np.ndarray):
    levels = int(np.log(_f32(min(src.shape))) / np.log(_f32(2.0)))
    xs, ys = [], []
    layer = src
    for _ in range(levels):
        xs.append(_gradient(layer, 0))
        ys.append(_gradient(np.ascontiguousarray(layer.T), 0))
        layer = _resize_linear(layer, layer.shape[1] // 2,
                               layer.shape[0] // 2)
    return xs, ys


def _contrast_sum(xs, ys) -> np.ndarray:
    total = np.zeros_like(xs[-1])
    for i in range(len(xs) - 1, -1, -1):
        gx = _gradient(xs[i], 1)
        gy = _gradient(ys[i], 1)
        total = _resize_linear(total, xs[i].shape[1], xs[i].shape[0])
        total = (total + (gx + gy.T)).astype(_f32)
    return total


def _signed_pow(src: np.ndarray, power) -> np.ndarray:
    sign = np.where(src > 0, _f32(1), _f32(-1))
    return (_pow(np.abs(src), power) * sign).astype(_f32)


def _dot(a: np.ndarray, b: np.ndarray) -> float:
    return float((a.astype(_f64) * b).sum())


def tonemap_mantiuk(hdr: np.ndarray, gamma: float = 2.2, scale: float = 0.7,
                    saturation: float = 1.0) -> np.ndarray:
    """cv2.createTonemapMantiuk(gamma, scale, saturation).process(hdr):
    the log luminance's contrast pyramid, each contrast mapped through
    ``sign(c) (scale |c|^0.4185)^(1 / 0.4185)``, and the luminance whose
    pyramid has those contrasts found by conjugate gradient (relative
    residual 1e-3, at most 100 iterations)."""
    img = _stretch(_hdr(hdr), 1.0)
    gray = _gray(img)
    log_img = _log(gray)
    if min(log_img.shape) < 2:
        raise ValueError("tonemap_mantiuk: the image is narrower than 2")
    rp = _f32(0.4185)
    xs, ys = _contrast(log_img)
    xs, ys = ([_signed_pow(_signed_pow(c, rp) * _f32(scale), _f32(1) / rp)
               for c in cs] for cs in (xs, ys))
    right = _contrast_sum(xs, ys)

    def product(v):
        return _contrast_sum(*_contrast(v))

    x = log_img.copy()
    r = (right - product(x)).astype(_f32)
    p = r.copy()
    target = _f32(_f32(_dot(right, right)) * np.power(_f32(1e-3), _f32(2)))
    rr = _f32(_dot(r, r))
    for _ in range(100):
        prod = product(p)
        dprod = _dot(p, prod)
        if not abs(dprod) > 0:
            raise ValueError("tonemap_mantiuk: the conjugate gradient "
                             "stalled (cv2: Assertion failed: fabs(dprod) "
                             "> 0)")
        alpha = _f32(rr / _f32(dprod))
        r = (r - alpha * prod).astype(_f32)
        x = (x + alpha * p).astype(_f32)
        new_rr = _f32(_dot(r, r))
        p = (r + _f32(new_rr / rr) * p).astype(_f32)
        rr = new_rr
        if rr < target:
            break
    with np.errstate(over="ignore"):
        x = np.exp(x).astype(_f32)
    img = _map_luminance(img, gray, x, saturation)
    return _stretch(img, gamma)
