"""Objective quality metrics: mel-cepstral distortion, log-F0 RMSE,
semitone accuracy, V/UV error.

The port's own copy of ``parallelwavegan_tpu/ops/eval_metrics.py`` (numpy
only; the port imports nothing of the JAX package), equivalent to the
reference's evaluation scripts (bin/evaluate_mcd.py, evaluate_f0.py,
utils/evaluate_semitone.py, utils/evaluate_vuv.py) without pysptk, pyworld
or fastdtw:
  - mcep: SPTK-exact mel-cepstral analysis — Newton minimization of the
    SPTK mcep criterion (the gamma=0 mel-generalized-cepstrum objective of
    Tokuda et al. on the FFT grid; see `mcep_from_periodogram`). The unique
    minimizer of this convex objective IS SPTK's fixed point, so MCD values
    are comparable with published SPTK/pysptk-based numbers.
  - DTW: a faithful reimplementation of the `fastdtw` package (radius=1
    coarse-to-fine DTW, identical window expansion and tie-breaking) for
    MCD; exact O(T1*T2) DTW is also available (`dtw_path`).
  - f0: the package's YIN (ops.audio.yin_f0)
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# fs -> (mcep_dim, alpha), following the reference's table
# (bin/evaluate_mcd.py)
MCEP_PARAMS = {
    8000: (13, 0.31),
    16000: (23, 0.42),
    22050: (34, 0.45),
    24000: (34, 0.46),
    32000: (36, 0.50),
    44100: (39, 0.53),
    48000: (39, 0.55),
}


def warped_phase(omega: np.ndarray, alpha: float) -> np.ndarray:
    """Phase beta(omega) of the first-order all-pass z~^-1 =
    (z^-1 - alpha)/(1 - alpha z^-1) evaluated at z = e^{j omega}."""
    return omega + 2.0 * np.arctan2(
        alpha * np.sin(omega), 1.0 - alpha * np.cos(omega)
    )


def mcep_from_periodogram(
    P: np.ndarray,
    order: int,
    alpha: float,
    n_fft: int,
    max_iter: int = 60,
    tol: float = 1e-12,
) -> np.ndarray:
    """SPTK-exact mel-cepstrum from periodogram frames.

    SPTK's `mcep` (wrapped by pysptk.mcep, used by the reference
    bin/evaluate_mcd.py) computes the gamma=0 mel-generalized
    cepstrum: the minimizer over mc of the discrete spectral criterion

        E(mc) = (1/N) sum_k [ P_k / |H_k|^2 + log|H_k|^2 - log P_k - 1 ]

    over the N-point DFT grid, where log|H_k|^2 = 2 sum_m mc_m cos(m b_k)
    and b_k = warped_phase(omega_k, alpha). E is strictly convex in mc
    (sum of exp-of-linear plus linear), so its stationary point is unique
    and equals SPTK's iterative fixed point; we find it by damped Newton
    with explicit gradient/Hessian, iterated to ~1e-12 (tighter than
    SPTK's default 1e-3 relative threshold).

    Args:
        P: (F, K) one-sided periodogram frames, K = n_fft//2 + 1.
        order: mel-cepstrum order M (returns M+1 coefficients).
        alpha: all-pass warping coefficient.
        n_fft: FFT length the periodogram was computed with.

    Returns:
        (F, order+1) float64 mel-cepstra.
    """
    P = np.asarray(P, dtype=np.float64)
    F, K = P.shape
    assert K == n_fft // 2 + 1
    omega = np.arange(K) * (np.pi / (K - 1))
    beta = warped_phase(omega, alpha)
    A = np.cos(np.outer(beta, np.arange(order + 1)))  # (K, M+1)
    # weights folding the symmetric (full-circle) DFT grid onto one side
    w = np.full(K, 2.0 / n_fft)
    w[0] = w[-1] = 1.0 / n_fft
    logP = np.log(P)

    def energy(mc):
        # exp argument clamped at 700: line-search candidates can overshoot
        # far past the optimum before damping rejects them, and exp(>709.8)
        # overflows float64. Any candidate with a clamped term has energy
        # >= exp(700)/n_fft >> E + 1e-15, so it is rejected either way and
        # the clamp never changes the accepted iterate path.
        R = logP - 2.0 * (mc @ A.T)
        return ((np.exp(np.minimum(R, 700.0)) - R - 1.0) * w).sum(-1)

    # init: weighted least-squares fit of the full log spectrum onto the
    # warped cosine basis (min sum_k w_k (logP_k - 2 mc.A_k)^2). Unlike a
    # gain-only init, this bounds the initial residual R on large-dynamic-
    # range frames, so exp(R) in the first Newton iteration cannot
    # overflow; the criterion is strictly convex so the converged result
    # is init-independent.
    gram = (A * w[:, None]).T @ A  # (M+1, M+1)
    rhs = (logP * w) @ A  # (F, M+1)
    mc = 0.5 * np.linalg.solve(gram, rhs.T).T
    E = energy(mc)
    wA = w[:, None] * A  # (K, M+1)
    for _ in range(max_iter):
        D = np.exp(logP - 2.0 * (mc @ A.T))  # P/|H|^2, (F, K)
        grad = 2.0 * ((1.0 - D) @ wA)  # (F, M+1)
        hess = 4.0 * np.einsum("fk,km,kn->fmn", D * w, A, A)
        step = np.linalg.solve(hess, grad[..., None])[..., 0]
        # damped update: halve per-frame steps until E does not increase
        t = np.ones((F, 1))
        for _ in range(30):
            E_new = energy(mc - t * step)
            bad = E_new > E + 1e-15
            if not bad.any():
                break
            t[bad] *= 0.5
        mc = mc - t * step
        rel = np.abs(E - E_new) / np.maximum(np.abs(E), 1e-300)
        E = E_new
        if rel.max() < tol:
            break
    return mc


def mcep(
    audio: np.ndarray,
    sampling_rate: int,
    fft_size: int = 512,
    shift_ms: float | None = None,
    dim: int | None = None,
    alpha: float | None = None,
    n_shift: int | None = None,
    eps: float = 1e-6,
) -> np.ndarray:
    """SPTK mel-cepstral coefficients per frame, shape (n_frames, dim + 1).

    Framing/windowing/flooring match the reference's sptk_extract
    (bin/evaluate_mcd.py): hamming window, hop n_shift (default 256),
    periodogram |FFT|^2 + eps with the audio in int16 scale (etype=1,
    eps=1e-6 as passed to pysptk.mcep there).
    """
    if dim is None or alpha is None:
        d, a = MCEP_PARAMS.get(sampling_rate, (34, 0.45))
        dim = dim if dim is not None else d
        alpha = alpha if alpha is not None else a
    if n_shift is None:
        n_shift = (
            int(sampling_rate * shift_ms * 1e-3)
            if shift_ms is not None else 256
        )
    # the reference loads wavs as int16; eps flooring only matches at that
    # scale. Our IO is float (-1, 1) -> rescale.
    audio = np.asarray(audio, dtype=np.float64)
    if np.abs(audio).max() <= 1.0 + 1e-6:
        audio = np.round(audio * 32767.0)
    n_frames = max(0, 1 + (len(audio) - fft_size) // n_shift)
    idx = (
        np.arange(n_frames)[:, None] * n_shift + np.arange(fft_size)[None, :]
    )
    frames = audio[idx] * np.hamming(fft_size)
    P = np.abs(np.fft.rfft(frames, axis=-1)) ** 2 + eps
    return mcep_from_periodogram(P, dim, alpha, fft_size).astype(np.float32)


# ---------------------------------------------------------------------------
# fastdtw (faithful reimplementation of the fastdtw PyPI package the
# reference uses: coarse-to-fine DTW with radius-1 projected windows,
# identical reduce/expand/tie-breaking semantics)
# ---------------------------------------------------------------------------

def _dtw_windowed(x, y, window) -> Tuple[float, List[Tuple[int, int]]]:
    """Windowed DTW with fastdtw's cell order and tie-breaking."""
    len_x, len_y = len(x), len(y)
    if window is None:
        window = [(i, j) for i in range(len_x) for j in range(len_y)]
    D = {(0, 0): (0.0, 0, 0)}
    inf = float("inf")
    for i, j in window:
        i1, j1 = i + 1, j + 1
        dt = float(np.sqrt(((x[i] - y[j]) ** 2).sum()))
        best = (inf, 0, 0)
        for cand in ((i, j1), (i1, j), (i, j)):
            prev = D.get(cand)
            if prev is not None and prev[0] + dt < best[0]:
                best = (prev[0] + dt, cand[0], cand[1])
        D[i1, j1] = best
    path = []
    i, j = len_x, len_y
    while not (i == 0 and j == 0):
        path.append((i - 1, j - 1))
        _, i, j = D[i, j]
    path.reverse()
    return D[len_x, len_y][0], path


def _reduce_by_half(x: np.ndarray) -> np.ndarray:
    n = len(x) - len(x) % 2
    return (x[0:n:2] + x[1:n:2]) / 2.0


def _expand_window(path, len_x, len_y, radius):
    path_ = set(path)
    for i, j in path:
        for a in range(-radius, radius + 1):
            for b in range(-radius, radius + 1):
                path_.add((i + a, j + b))
    window_ = set()
    for i, j in path_:
        window_.update(
            ((i * 2, j * 2), (i * 2, j * 2 + 1),
             (i * 2 + 1, j * 2), (i * 2 + 1, j * 2 + 1))
        )
    window = []
    start_j = 0
    for i in range(len_x):
        new_start_j = None
        for j in range(start_j, len_y):
            if (i, j) in window_:
                window.append((i, j))
                if new_start_j is None:
                    new_start_j = j
            elif new_start_j is not None:
                break
        start_j = new_start_j if new_start_j is not None else start_j
    return window


def fastdtw_path(
    x: np.ndarray, y: np.ndarray, radius: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """fastdtw alignment path (reference default: radius=1, euclidean)."""

    def _fastdtw(x, y):
        if len(x) < radius + 2 or len(y) < radius + 2:
            return _dtw_windowed(x, y, None)
        _, path = _fastdtw(_reduce_by_half(x), _reduce_by_half(y))
        window = _expand_window(path, len(x), len(y), radius)
        return _dtw_windowed(x, y, window)

    _, path = _fastdtw(np.asarray(x, float), np.asarray(y, float))
    twf = np.array(path).T
    return twf[0], twf[1]


def dtw_path(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """DTW alignment path between frame sequences (T1, D), (T2, D)."""
    t1, t2 = len(x), len(y)
    dist = np.sqrt(
        np.maximum(
            (x**2).sum(-1)[:, None]
            - 2 * x @ y.T
            + (y**2).sum(-1)[None, :],
            0.0,
        )
    )
    acc = np.full((t1 + 1, t2 + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, t1 + 1):
        row = dist[i - 1]
        prev = acc[i - 1]
        cur = acc[i]
        for j in range(1, t2 + 1):
            cur[j] = row[j - 1] + min(prev[j], cur[j - 1], prev[j - 1])
    # backtrack
    path_x, path_y = [], []
    i, j = t1, t2
    while i > 0 and j > 0:
        path_x.append(i - 1)
        path_y.append(j - 1)
        choices = (acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
        move = int(np.argmin(choices))
        if move == 0:
            i, j = i - 1, j - 1
        elif move == 1:
            i -= 1
        else:
            j -= 1
    return np.array(path_x[::-1]), np.array(path_y[::-1])


def mel_cepstral_distortion(
    gen_audio: np.ndarray,
    gt_audio: np.ndarray,
    sampling_rate: int,
    fft_size: int = 512,
    n_shift: int = 256,
) -> float:
    """MCD in dB between generated and ground-truth waves.

    Matches reference evaluate_mcd.py: SPTK mcep frames, fastdtw
    (radius 1, euclidean) alignment, and the squared difference summed over
    ALL mcep columns including the 0th (gain) coefficient — which is why
    mcep() fixes the int16 amplitude scale.
    """
    mc_gen = mcep(gen_audio, sampling_rate, fft_size, n_shift=n_shift)
    mc_gt = mcep(gt_audio, sampling_rate, fft_size, n_shift=n_shift)
    px, py = fastdtw_path(mc_gen, mc_gt)
    diff = mc_gen[px] - mc_gt[py]
    return float(
        np.mean(10.0 / np.log(10.0) * np.sqrt(2.0 * (diff**2).sum(-1)))
    )


def log_f0_rmse(
    gen_audio: np.ndarray,
    gt_audio: np.ndarray,
    sampling_rate: int,
    hop_size: int | None = None,
    f0min: float = 40.0,
    f0max: float = 800.0,
) -> Tuple[float, float]:
    """(log-F0 RMSE over co-voiced DTW-aligned frames, V/UV error rate)."""
    from parallelwavegan_torch.ops.audio import yin_f0

    if hop_size is None:
        hop_size = int(sampling_rate * 0.005)
    f0_gen = yin_f0(gen_audio, sampling_rate, hop_size, f0min, f0max)
    f0_gt = yin_f0(gt_audio, sampling_rate, hop_size, f0min, f0max)
    n = min(len(f0_gen), len(f0_gt))
    f0_gen, f0_gt = f0_gen[:n], f0_gt[:n]
    # align on mcep features (f0 sequences can be degenerate)
    mc_gen = mcep(gen_audio, sampling_rate, shift_ms=hop_size / sampling_rate * 1e3)
    mc_gt = mcep(gt_audio, sampling_rate, shift_ms=hop_size / sampling_rate * 1e3)
    m = min(len(mc_gen), n), min(len(mc_gt), n)
    px, py = dtw_path(mc_gen[: m[0]], mc_gt[: m[1]])
    g, r = f0_gen[px], f0_gt[py]
    voiced = (g > 0) & (r > 0)
    vuv_error = float(np.mean((g > 0) != (r > 0)))
    if voiced.sum() == 0:
        return float("nan"), vuv_error
    rmse = float(
        np.sqrt(np.mean((np.log(g[voiced]) - np.log(r[voiced])) ** 2))
    )
    return rmse, vuv_error


def semitone_accuracy(
    gen_audio: np.ndarray,
    gt_audio: np.ndarray,
    sampling_rate: int,
    tolerance: float = 0.5,
) -> float:
    """Fraction of co-voiced frames within +-tolerance semitones."""
    from parallelwavegan_torch.ops.audio import yin_f0

    hop = int(sampling_rate * 0.005)
    f0_gen = yin_f0(gen_audio, sampling_rate, hop)
    f0_gt = yin_f0(gt_audio, sampling_rate, hop)
    n = min(len(f0_gen), len(f0_gt))
    g, r = f0_gen[:n], f0_gt[:n]
    voiced = (g > 0) & (r > 0)
    if voiced.sum() == 0:
        return float("nan")
    semitones = 12.0 * np.abs(np.log2(g[voiced] / r[voiced]))
    return float(np.mean(semitones <= tolerance))
