"""Kaldi-compatible log-mel filterbank front end (port of
anyref_tpu/ops/mel.py).

waveform -> 3 clips of 2 s -> kaldi fbank (25 ms / 10 ms Hann window, 128
mel bins, 16 kHz, no dither) -> frames padded or cut to 204 ->
(x - mean) / std, as ImageBind's audio loader computes it with torchaudio.
Framing is a gather, the spectrum ``torch.fft.rfft`` and the mel weights
one product, all on the waveform's device. torchaudio's kaldi semantics:
  * snip-edges framing: frame i covers samples [i*160, i*160+400);
  * the DC offset removed per frame;
  * pre-emphasis 0.97 with the first sample repeated;
  * a symmetric Hann window, the FFT padded to 512;
  * the power spectrum; mel banks on 256 FFT bins, low_freq 20,
    high_freq Nyquist; log(max(e, EPS)).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..params import resolve_device

MEL_LOW_FREQ = 20.0
PREEMPH = 0.97
EPS = 1.1920928955078125e-07  # float32 epsilon (torchaudio _get_epsilon)


def _mel(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@functools.lru_cache(maxsize=8)
def _mel_banks(num_bins: int, fft_len: int, sample_rate: float) -> np.ndarray:
    """Kaldi's triangular mel filterbank, [num_bins, fft_len // 2] fp32."""
    nyquist = 0.5 * sample_rate
    num_fft_bins = fft_len // 2
    fft_bin_width = sample_rate / fft_len
    mel_low = _mel(MEL_LOW_FREQ)
    mel_high = _mel(nyquist)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.zeros((num_bins, num_fft_bins), np.float32)
    mel_freqs = _mel(fft_bin_width * np.arange(num_fft_bins))
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bins[b] = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return bins


@functools.lru_cache(maxsize=8)
def _hann(win: int) -> np.ndarray:
    """Symmetric Hann window of ``win`` samples, fp32."""
    n = np.arange(win)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / (win - 1))).astype(
        np.float32)


def kaldi_fbank(waveform: torch.Tensor, sample_rate: int = 16000,
                num_mel_bins: int = 128, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0) -> torch.Tensor:
    """waveform [..., N] -> log-mel [..., num_frames, num_mel_bins] fp32, on
    the waveform's device. N must hold at least one window."""
    win = int(sample_rate * frame_length_ms / 1000.0)      # 400
    shift = int(sample_rate * frame_shift_ms / 1000.0)     # 160
    fft_len = 1 << (win - 1).bit_length()                   # 512
    dev = waveform.device
    num_frames = 1 + (waveform.shape[-1] - win) // shift
    if num_frames <= 0:
        raise ValueError(f"kaldi_fbank: {waveform.shape[-1]} samples hold no "
                         f"window of {win}")
    idx = (torch.arange(num_frames, device=dev)[:, None] * shift
           + torch.arange(win, device=dev)[None, :])        # [F, win]
    frames = waveform.float()[..., idx]                      # [..., F, win]
    frames = frames - frames.mean(-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], -1)
    frames = frames - PREEMPH * prev
    frames = frames * torch.from_numpy(_hann(win)).to(dev)
    spec = torch.fft.rfft(frames, n=fft_len, dim=-1)
    power = spec.abs().square()[..., :fft_len // 2]         # drop Nyquist
    banks = torch.from_numpy(_mel_banks(num_mel_bins, fft_len,
                                        float(sample_rate))).to(dev)
    mel = power @ banks.T
    return torch.log(torch.clamp_min(mel, EPS))


def clip_timepoints(duration_s: float, clip_duration: float = 2.0,
                    clips_per_audio: int = 3) -> list[tuple[float, float]]:
    """pytorchvideo's ConstantClipsPerVideoSampler (reference data.py:67-76):
    clip starts spaced by max(duration - clip_duration, 0) / clips (not
    clips - 1), so a 5 s audio gives starts 0, 1 and 2 s."""
    delta = max(duration_s - clip_duration, 0.0)
    uniform = delta / max(clips_per_audio, 1)
    return [(i * uniform, i * uniform + clip_duration)
            for i in range(clips_per_audio)]


def audio_to_mel_clips(waveform, sample_rate: int = 16000,
                       num_mel_bins: int = 128, target_len: int = 204,
                       clip_duration: float = 2.0, clips_per_audio: int = 3,
                       mean: float = -4.268, std: float = 9.138,
                       device="cuda") -> torch.Tensor:
    """The whole front end for one audio: waveform [N] (array or tensor) ->
    [clips, 1, mel_bins, target_len] fp32 on ``device`` (reference
    load_and_transform_audio_data, data.py:114-161). A clip shorter than
    one 25 ms window has no frames; frames, not samples, are zero-padded to
    ``target_len`` (padding the waveform would fill the tail with log(EPS)
    frames)."""
    dev = resolve_device(device)
    if not torch.is_tensor(waveform):
        waveform = torch.from_numpy(np.asarray(waveform, np.float32))
    wav = waveform.to(dev, torch.float32)
    wav = wav - wav.mean()      # the per-file mean removal (data.py:30)
    duration = wav.shape[0] / sample_rate
    clips = []
    for start, end in clip_timepoints(duration, clip_duration,
                                      clips_per_audio):
        clip = wav[int(start * sample_rate):int(end * sample_rate)]
        fb = torch.zeros((num_mel_bins, target_len), dtype=torch.float32,
                         device=dev)
        if clip.shape[0] >= int(0.025 * sample_rate):
            mel = kaldi_fbank(clip, sample_rate, num_mel_bins).T   # [mel, F]
            n = min(mel.shape[1], target_len)
            fb[:, :n] = mel[:, :n]
        clips.append(fb[None])
    return (torch.stack(clips) - mean) / std
