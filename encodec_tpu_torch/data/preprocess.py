"""Signal-processing library for respiration data.

A copy of `encodec_tpu/data/preprocess.py` (numpy, with scipy imported
inside the functions that use it). Behavioral reference:
encodec/data/preprocess.py — motion-artifact normalization
(detect_motion_iterative 197-221), robust std (257-264),
crop/normalize helpers (188-194), static-signal detection (173-185), label
standardization (358-420) and Butterworth filters (422-436). Pure
numpy/scipy — this runs in data-loading workers on the host, feeding
fixed-shape batches to the device.
"""

from __future__ import annotations

import typing as tp

import numpy as np


def label_to_interval(label: np.ndarray, val=0) -> np.ndarray:
    """[start, end) intervals where `label == val` (ref preprocess.py:283)."""
    hit = (np.asarray(label) == val).astype(int).ravel()
    a = np.diff(np.concatenate([[0], hit, [0]]))
    left = np.where(a == 1)[0]
    right = np.where(a == -1)[0]
    return np.array(list(zip(left, right)), dtype=np.int32).reshape(-1, 2)


def signal_std(signal: np.ndarray) -> float:
    """Trimmed std: drop the top/bottom 10% of values (ref 257-264)."""
    if len(signal) < 10:
        return 1.0
    cut = int(len(signal) * 0.1)
    std = float(np.std(np.sort(signal)[cut:-cut]))
    return 1.0 if std == 0 else std


def signal_normalize(signal: np.ndarray) -> np.ndarray:
    signal = signal - np.mean(signal)
    return signal / signal_std(signal)


def signal_crop(signal: np.ndarray, clip_limit: float = 6.0) -> np.ndarray:
    return np.clip(signal, -clip_limit, clip_limit)


def norm_sig(input_sig: np.ndarray) -> np.ndarray:
    return (input_sig - np.mean(input_sig)) / np.std(input_sig)


def signal_crop_motion(signal: np.ndarray, window: float = 10,
                       fs: float = 10, threshold: float = 5):
    """Drop samples within `window` seconds of high-amplitude motion
    (ref preprocess.py:272-281)."""
    from scipy.ndimage import minimum_filter1d
    signal_norm = signal_normalize(signal)
    threshold = max(np.max(np.abs(signal_norm)) * 0.5, threshold)
    normal_part = np.abs(signal_norm) < threshold
    normal_part = minimum_filter1d(normal_part, int(window * fs))
    indices = np.where(normal_part == 1)[0]
    return signal_norm[indices], indices


def detect_motion_iterative(signal: np.ndarray, fs: float = 10,
                            level: int = 3):
    """Motion-artifact normalization via a depth-limited segmentation tree
    (behavioral contract: ref preprocess.py:197-221).

    Semantics: the signal is split at motion events into stable spans, each
    span is renormalized by its trimmed std (re-splitting up to `level`
    deep), the gap following each span is rescaled by that span's ratio so
    amplitudes stay continuous across seams, and every node clips to ±8.
    Returns (normalized_signal, right_most_ratio, motion_mask) where
    right_most_ratio is the trailing span's cumulative scale — callers use
    it to rescale whatever follows this segment.

    Implementation: rather than recursing, the whole segmentation tree is
    materialized first (top-down — a node's split depends only on its
    ancestors' mean-centering side effects, never on siblings or children),
    then normalization ratios propagate in one bottom-up sweep. The two
    passes make the data flow explicit: splits read, the sweep writes.
    """
    work = np.asarray(signal, dtype=np.float64).copy()
    motion = np.ones(len(work), dtype=int)

    # --- pass 1: grow the tree. nodes[i] = [lo, hi, child indices];
    # appended children always follow their parent, so iterating the list
    # forward IS a top-down traversal and backward a bottom-up one.
    nodes = [[0, len(work), []]]
    todo = [(0, fs, level)]  # (node index, node's fs, remaining depth)
    leaves = set()
    while todo:
        idx, node_fs, depth = todo.pop()
        lo, hi, kids = nodes[idx]
        if depth == 0 or hi - lo < 30 * node_fs:
            leaves.add(idx)  # plain trimmed-std base case, handled in pass 2
            continue
        seg = work[lo:hi]
        # Split at motion events. The split thresholds amplitudes against
        # the trimmed std; it also centers `seg` in place — a side effect
        # of the upstream pipeline (signal_normalize, ref preprocess.py:268)
        # that later splits observe, so it must happen here, mid-walk. A
        # top-level split that kept every sample is retried once at a
        # tighter threshold (ref preprocess.py:207-208).
        _, keep = signal_crop_motion(seg, window=10, threshold=10, fs=node_fs)
        seg -= np.mean(seg)
        if depth == 3 and len(keep) == hi - lo:
            _, keep = signal_crop_motion(seg, window=10, threshold=6,
                                         fs=node_fs)
            seg -= np.mean(seg)
        local = np.ones(hi - lo, dtype=int)
        local[keep] = 0
        motion[lo:hi] = local
        # Stable spans become children. Sub-splits always run at the
        # default fs=10 regardless of the caller's fs (a quirk of the
        # upstream recursion's argument threading, ref preprocess.py:211)
        for p0, p1 in label_to_interval(local, 0):
            kids.append(len(nodes))
            nodes.append([lo + p0, lo + p1, []])
            todo.append((kids[-1], 10, depth - 1))

    # --- pass 2: bottom-up sweep. Leaves normalize by trimmed std; inner
    # nodes splice their children's ratios into the gaps between spans
    # (gaps and spans are disjoint, so child writes never collide with gap
    # rescales) and inherit the LAST child's ratio as their own — the
    # amplitude continuation for whatever follows. Every node clips ±8.
    ratio = [1.0] * len(nodes)
    for idx in range(len(nodes) - 1, -1, -1):
        lo, hi, kids = nodes[idx]
        if idx in leaves:
            std = signal_std(work[lo:hi])
            work[lo:hi] = np.clip(work[lo:hi] / std, -8.0, 8.0)
            ratio[idx] = 1.0 / std
            # Only the root-as-leaf case still carries nonzero motion here
            # (non-root leaves were zeroed by the parent's span marking in
            # pass 1); kept unconditional for clarity, it is a no-op then.
            motion[lo:hi] = 0
            continue
        # A splitting node with no stable span (wall-to-wall artifact)
        # keeps ratio 1.0 and motion 1 everywhere; it still clips.
        for left, right in zip(kids[:-1], kids[1:]):
            work[nodes[left][1]:nodes[right][0]] *= ratio[left]
        if kids:
            ratio[idx] = ratio[kids[-1]]
        work[lo:hi] = np.clip(work[lo:hi], -8.0, 8.0)
    return work, ratio[0], motion


def detect_static_signal(signal: np.ndarray, fs: float = 10):
    """Flag spans whose sample-to-sample diff stays under a threshold for
    30 s (flat / disconnected sensor; ref preprocess.py:173-185)."""
    from scipy.ndimage import minimum_filter1d
    signal = np.asarray(signal).copy()
    sig_diff = np.diff(np.concatenate([[0.0], signal]))
    static_part = sig_diff < 0.02
    static_part = minimum_filter1d(static_part, int(30 * fs))
    indices = np.where(static_part == 1)[0]
    non_static = np.where(static_part == 0)[0]
    return static_part, 1 - static_part, non_static


def detect_constant_windows(signal: np.ndarray, fs: float = 10,
                            window_sec: float = 30.0,
                            std_threshold: float = 1e-6) -> np.ndarray:
    """Sliding-window zero/constant detection — the blocklist criterion of
    the reference's offline curation (data/get_fns_to_ignore.py). Returns
    [start, end) intervals of constant spans."""
    win = max(1, int(window_sec * fs))
    if len(signal) < win:
        return np.zeros((0, 2), np.int32)
    # rolling std via cumulative sums
    x = np.asarray(signal, np.float64)
    c1 = np.concatenate([[0.0], np.cumsum(x)])
    c2 = np.concatenate([[0.0], np.cumsum(x * x)])
    n = len(x) - win + 1
    s1 = c1[win:] - c1[:-win]
    s2 = c2[win:] - c2[:-win]
    var = np.maximum(s2 / win - (s1 / win) ** 2, 0.0)
    flat = np.sqrt(var) < std_threshold
    mask = np.zeros(len(x), bool)
    idx = np.where(flat)[0]
    for i in idx:
        mask[i:i + win] = True
    return label_to_interval(mask.astype(int), 1)


# ---------------------------------------------------------------------------
# SNR scoring / sleep bounds (ref preprocess.py:24-170)
# ---------------------------------------------------------------------------

STANDARD_FS = 5
BPS_RANGE = np.array([8.0, 30.0])  # plausible breaths/minute


def normalize_signals_percentile(signal: np.ndarray, p: float = 1) -> np.ndarray:
    """Clip to the [p, 100-p] percentiles and unit-std (ref 17-22)."""
    floor = np.percentile(signal, p)
    ceil = np.percentile(signal, 100 - p)
    signal = signal.clip(floor, ceil)
    return signal / np.std(signal)


def get_sleep_start_end(stages: np.ndarray):
    """Longest contiguous sleep period from 30 s stage epochs, after
    filling short wake gaps (ref preprocess.py:24-46)."""
    stages_binary = np.clip(np.asarray(stages).copy(), 0, 1)
    for start, end in label_to_interval(stages_binary, 0):
        if end - start < 10 and start > 0 and end < len(stages):
            stages_binary[start:end] = 1
    for start, end in label_to_interval(stages_binary, 1):
        if end - start < 20:
            stages_binary[start:end] = 0
            break
    for start, end in label_to_interval(stages_binary, 0):
        if end - start < 240 and start > 0 and end < len(stages):
            stages_binary[start:end] = 1
    sleep_periods = sorted(label_to_interval(stages_binary, 1),
                           key=lambda a: a[1] - a[0])
    if len(sleep_periods) > 0:
        return int(sleep_periods[-1][0]), int(sleep_periods[-1][1])
    return 0, 1


def signal_snr(signal: np.ndarray, fs: float = STANDARD_FS,
               with_std: bool = True):
    """Breathing-band SNR: median over STFT segments of (energy around the
    dominant breathing peak + its harmonic) / total energy, optionally
    penalized by peak-frequency jitter (ref preprocess.py:48-170).
    Returns (snr, per-segment scores) or 0 for signals under 30 s."""
    from scipy.signal import spectrogram
    if len(signal) < 30 * fs:
        return 0
    _, _, spec = spectrogram(signal, fs, ("tukey", 0.25), int(15 * fs),
                             int(10 * fs), int(30 * fs), "constant", True,
                             mode="magnitude")
    energy_sum = np.sum(spec, axis=0)
    peak_index = np.argmax(spec, axis=0)
    peak_index[np.where(peak_index * 2 < BPS_RANGE[0])] = 0
    peak_index[np.where(peak_index * 2 > BPS_RANGE[1])] = 0
    col_score = np.zeros(spec.shape[1])
    for i in range(spec.shape[1]):
        if peak_index[i] > 0:
            col_score[i] = np.sum(spec[peak_index[i] - 1:peak_index[i] + 2, i])
            col_score[i] += np.sum(
                spec[peak_index[i] * 2 - 1:peak_index[i] * 2 + 2, i])
    col_score /= energy_sum + 1e-5
    snr = np.median(col_score)
    if with_std:
        snr = snr - 0.01 * np.std(peak_index)
    return snr, col_score


# ---------------------------------------------------------------------------
# Label standardization (ref preprocess.py:358-420)
# ---------------------------------------------------------------------------

def stage_mapping(stages: np.ndarray) -> np.ndarray:
    """R&K → collapsed stages: 4→3 (deep), 5→4 (REM), >4 → 0 (errors).
    Mutates in place like the reference (preprocess.py:402-406)."""
    stages[stages == 4] = 3
    stages[stages == 5] = 4
    stages[stages > 4] = 0
    return stages.astype(np.int32)


APNEA_LABELS = {"Hypopnea": 1, "Obstructive Apnea": 2, "Central Apnea": 3,
                "Mixed Apnea": 4}


def apnea_mapping(event_name: str) -> int:
    try:
        return APNEA_LABELS[event_name]
    except KeyError:
        raise Exception(
            f"Error: unknown type of apnea/hypopnea ({event_name})!")


def standardize_stage(stages: np.ndarray, epoch_length: int = 30,
                      fs: int = 10) -> np.ndarray:
    return np.repeat(stage_mapping(stages), epoch_length * fs, axis=0)


def standardize_apnea(apnea_events, signal_length: int, fs: int = 10,
                      mapping: tp.Optional[tp.Callable[[str], int]] = None) -> np.ndarray:
    labels = np.zeros(signal_length, dtype=np.int32)
    mapping = mapping or apnea_mapping
    for event_name, start, duration in apnea_events:
        labels[int(start * fs):int((start + duration) * fs)] = mapping(event_name)
    return labels


def standardize_arousal(events, length: int, fs: int = 256) -> np.ndarray:
    labels = np.zeros(length, dtype=np.int32)
    for _name, start, duration in events:
        labels[int(start * fs):int((start + duration) * fs)] = 1
    return labels


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------

def butter_bandpass_filter(data, cutoff1, cutoff2, fs, order=5):
    from scipy.signal import butter, lfilter
    nyq = 0.5 * fs
    b, a = butter(order, [cutoff1 / nyq, cutoff2 / nyq], btype="band")
    return lfilter(b, a, data)


def butter_lowpass_filter(data, cutoff, fs, order=5):
    from scipy.signal import butter, lfilter
    nyq = 0.5 * fs
    b, a = butter(order, cutoff / nyq, btype="low")
    return lfilter(b, a, data)


# ---------------------------------------------------------------------------
# Trend removal, interpolation, local statistics (ref preprocess.py:390-552)
# ---------------------------------------------------------------------------

def trend(x: np.ndarray, window_length: int = 51, polyorder: int = 2):
    from scipy.signal import savgol_filter
    return savgol_filter(x, window_length, polyorder)


def detrend(x: np.ndarray, window_length: tp.Optional[int] = None,
            polyorder: int = 2, fs: int = 10):
    """Subtract a Savitzky-Golay trend; default window 2*15s*fs + 1."""
    if window_length is None:
        window_length = int(fs * 15) * 2 + 1
    return x - trend(x, window_length, polyorder)


def interpol_signal(s: np.ndarray, old_f: float, new_f: float,
                    type: str = "slinear") -> np.ndarray:
    """Resample via interpolation with the reference's end-padding rules
    (ref preprocess.py:439-456)."""
    from scipy import interpolate
    if old_f == new_f:
        return s
    x = np.arange(s.shape[0])
    if type in ("slinear", "quadratic", "nearest"):
        f = interpolate.interp1d(x, s, kind=type)
    elif type == "spline":
        f = interpolate.UnivariateSpline(x, s)
    else:
        raise RuntimeWarning("Unknown type of interpolation.")
    tempf = f(np.arange(0, s.shape[0] - 1, old_f / new_f))
    if old_f > new_f:
        return tempf
    elif 2 * old_f > new_f:
        return np.append(tempf, s[-1])
    return np.append(tempf, [s[-1], s[-1]])


def interpol_signal_2d(s: np.ndarray, old_f: float, new_f: float,
                       type: str = "quadratic") -> np.ndarray:
    """Row-wise interpolation; note the reference always end-pads rows
    (1 or 2 samples), even when downsampling (ref preprocess.py:458-479)."""
    from scipy import interpolate
    if old_f == new_f:
        return s
    x = np.arange(s.shape[1])
    out = None
    for r in range(s.shape[0]):
        if type in ("slinear", "quadratic", "nearest"):
            f = interpolate.interp1d(x, s[r], kind=type)
        elif type == "spline":
            f = interpolate.UnivariateSpline(x, s[r])
        else:
            raise RuntimeWarning("Unknown type of interpolation.")
        row = f(np.arange(0, s.shape[1] - 1, old_f / new_f))
        if 2 * old_f > new_f:
            row = np.append(row, s[r][-1])
        else:
            row = np.append(row, [s[r][-1], s[r][-1]])
        if out is None:
            out = np.zeros((s.shape[0], row.shape[0]), "float32")
        out[r] = row
    return out


def one_runs(a: np.ndarray) -> np.ndarray:
    """[start, end) runs of truthy values (ref preprocess.py:482-488)."""
    iszero = np.concatenate(([0], a, [0]))
    absdiff = np.abs(np.diff(iszero))
    return np.where(absdiff == 1)[0].reshape(-1, 2)


def AHI(apnea_label: np.ndarray, stage_label: np.ndarray, signal_size: int):
    """Apnea event counts + sleep hours per sliding window (10 Hz labels;
    ref preprocess.py:491-524). Returns (nums, hours) float32 arrays."""
    import math as _math
    if signal_size > 0:
        batch_num = _math.ceil(apnea_label.shape[0] / signal_size) * 2
        step = _math.floor((apnea_label.shape[0] - signal_size) / (batch_num - 1))
    else:
        batch_num = 1
        step = apnea_label.shape[0]
        signal_size = apnea_label.shape[0]
    runs = one_runs(np.logical_and(apnea_label > 0, stage_label > 0))
    nums = np.zeros(batch_num)
    hours = np.zeros(batch_num)
    for i in range(batch_num):
        for j in range(runs.shape[0]):
            length = runs[j, 1] - runs[j, 0]
            if length < 10 * 10:  # < 10 seconds
                continue
            if runs[j, 0] >= i * step and runs[j, 1] <= i * step + signal_size:
                nums[i] += 1
            elif i * step <= runs[j, 0] <= i * step + signal_size:
                nums[i] += (i * step + signal_size - runs[j, 0]) / length
            elif i * step <= runs[j, 1] <= i * step + signal_size:
                nums[i] += (runs[j, 1] - i * step) / length
        hours[i] = (stage_label[i * step:i * step + signal_size] > 0).sum() / 36000
    return nums.astype("float32"), hours.astype("float32")


def compute_local_std_1d(length: int, input_data: np.ndarray):
    """Windowed-std normalization via convolution (ref 538-552)."""
    from scipy.signal import convolve
    assert length % 2 == 0
    kernel = np.ones((length,), "float32") / length
    local_mean = convolve(input_data, kernel, mode="same")
    residual_sq = (input_data - local_mean) ** 2
    local_std = convolve(residual_sq, kernel, mode="same") ** 0.5 + 1e-30
    return np.divide(input_data, local_std), local_std


def zoom_complex(input: np.ndarray, ratio: float) -> np.ndarray:
    """Resample a complex array by zooming real/imag separately (ref 292)."""
    from scipy.ndimage import zoom as _zoom
    out_real = _zoom(input.real, ratio)
    out = np.zeros(out_real.shape, np.complex64)
    out.real = out_real
    out.imag = _zoom(input.imag, ratio)
    return out


def standardize_desaturation(apnea_events, length: int, fs: int = 1) -> np.ndarray:
    """Desaturation-depth label track (ref preprocess.py:382-387): events are
    (name, start, duration, desat) tuples; each paints `int(desat)` over its
    [start, start+duration) span at rate `fs`."""
    desat_labels = np.zeros(length, dtype=np.int32)
    for _, start, duration, desat in apnea_events:
        desat_labels[int(start * fs):int((start + duration) * fs)] = int(desat)
    return desat_labels


# -- EEG spectrogram utilities (ref preprocess.py:554-640) -------------------
# The reference's versions reference module constants (EEG_RAW_FS,
# EEG_SPEC_HEIGHT, EEG_SPEC_MAX_FREQ) that are never defined anywhere in the
# repo — calling them raises NameError (dead code). The algorithm is ported
# with those constants made explicit module attributes, defaulting to the
# conventional polysomnography EEG settings they imply.

EEG_RAW_FS = 256            # raw EEG sampling rate (Hz)
EEG_SPEC_HEIGHT = 128       # output spectrogram rows
EEG_SPEC_MAX_FREQ = 32      # top frequency kept (Hz)


def get_spec_eeg(eeg_data: np.ndarray, nfft_window_size: int, step: int,
                 is_pad: bool = True, freq_threshold: int = 32,
                 raw_fs: int = None) -> np.ndarray:
    """Hann magnitude spectrogram of raw EEG with the reference's
    negative-frequency fold (`s[1:] += s[1:][::-1]`) and DC drop
    (ref preprocess.py:613-627). Window/step are in seconds."""
    from scipy.signal import spectrogram
    fs = EEG_RAW_FS if raw_fs is None else raw_fs
    if is_pad:
        pad = np.zeros(fs * ((nfft_window_size - step) // 2), np.float64)
        eeg_data = np.concatenate((pad, eeg_data, pad), axis=0)
    nfft = nfft_window_size * fs
    step_n = step * fs
    freq_index_max = 1 + nfft_window_size * freq_threshold
    _, _, s = spectrogram(x=eeg_data, window="hann", nperseg=nfft,
                          noverlap=nfft - step_n, nfft=nfft,
                          detrend="linear", mode="magnitude")
    s[1:] += s[1:][::-1]
    return s[1:freq_index_max, :]


def whole_spec_eeg(eeg_data: np.ndarray, nfft_window_size: int, step: int,
                   win_num: int = 30, freq_threshold: int = 32,
                   raw_fs: int = None) -> np.ndarray:
    """Piecewise full-night EEG spectrogram with overlap-padded seams and
    row-binned power pooling (ref `_whole_spec_eeg`, preprocess.py:554-610).
    Returns `[EEG_SPEC_HEIGHT, T']` float32."""
    fs = EEG_RAW_FS if raw_fs is None else raw_fs
    assert (nfft_window_size - step) % 2 == 0
    signal_cut_length = win_num * nfft_window_size * fs
    total_length = eeg_data.shape[0]
    pieces = total_length // signal_cut_length
    if pieces == 0:
        raise ValueError(
            f"EEG signal too short: {total_length} samples < one "
            f"{signal_cut_length}-sample piece (win_num * window * fs)")
    pad_length = fs * ((nfft_window_size - step) // 2)

    chunks = []
    for i in range(pieces):
        start = i * signal_cut_length
        # the last piece takes the remainder (ref behavior)
        body = eeg_data[start:] if i == pieces - 1 \
            else eeg_data[start:start + signal_cut_length]
        # halo context from neighboring data, zero-padded at the edges —
        # uniform handling (the ref's branch ordering dropped the front
        # zero-pad entirely when pieces == 1)
        front = (eeg_data[start - pad_length:start] if i > 0
                 else np.zeros((pad_length,), np.float64))
        rear_src = eeg_data[start + body.shape[0]:
                            start + body.shape[0] + pad_length]
        rear = np.concatenate(
            (rear_src, np.zeros((pad_length - rear_src.shape[0],),
                                np.float64)))
        eeg_cut = np.concatenate((front, body, rear), axis=0)
        result = get_spec_eeg(eeg_cut, nfft_window_size, step, is_pad=False,
                              freq_threshold=freq_threshold, raw_fs=fs)
        power = np.zeros([EEG_SPEC_HEIGHT, result.shape[1]], "float32")
        freq_step = (EEG_SPEC_MAX_FREQ * nfft_window_size) / EEG_SPEC_HEIGHT
        for row in range(EEG_SPEC_HEIGHT):
            power[row] = np.sum(
                result[int(row * freq_step):int((row + 1) * freq_step - 1)]
                ** 2, axis=0) ** 0.5
        chunks.append(power)
    return np.concatenate(chunks, axis=1)
