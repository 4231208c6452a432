"""AVSBench audio-referred segmentation (port of anyref_tpu/data/avs.py;
reference utils/avsbench.py).

S4 (single-source, "avs_object"): CSV-driven; 1 frame/video train, 5 frames
val/test. MS3 (multi-source, "avs_multi"): 5 frames/video all splits, no
class names. Audio goes through the ImageBind mel front end (ops.mel,
replacing torchaudio) on the reader's ``device`` (the port's device rule:
"cuda" unless told otherwise; evaluate_avs sets it to the Predictor's), and
the clips come back to the host as numpy for the collator."""

from __future__ import annotations

import csv
import os
import wave

import numpy as np

from ..ops.mel import audio_to_mel_clips
from ..tokenizer import audio_ref_question
from .base import SegDataset, load_image_rgb

AVS_CATEGORY_TO_CLASS = {
    "helicopter": "helicopter", "mynah_bird_singing": "bird",
    "typing_on_computer_keyboard": "keyboard", "playing_violin": "violin",
    "playing_glockenspiel": "glockenspiel", "playing_piano": "piano",
    "lions_roaring": "lion", "baby_laughter": "baby", "male_speech": "male",
    "lawn_mowing": "lawn mower", "playing_ukulele": "ukulele",
    "playing_tabla": "tabla", "driving_buses": "bus",
    "cap_gun_shooting": "cap gun", "chainsawing_trees": "chainsaw",
    "playing_acoustic_guitar": "guitar", "cat_meowing": "cat",
    "female_singing": "female", "ambulance_siren": "ambulance",
    "dog_barking": "dog", "horse_clip-clop": "horse",
    "coyote_howling": "coyote", "race_car": "car",
}


def load_wav(path: str, target_rate: int = 16000) -> np.ndarray:
    """Mono waveform at target_rate (stdlib wave + linear resample; replaces
    torchaudio.load + resample)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        channels = w.getnchannels()
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    if rate != target_rate:
        src = np.arange(len(data)) / rate
        dst = np.arange(int(len(data) * target_rate / rate)) / target_rate
        data = np.interp(dst, src, data).astype(np.float32)
    return data


def load_mask_png(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return (np.asarray(im.convert("1")) > 0).astype(np.uint8)


def _mel_clips(audio_file: str, device) -> np.ndarray:
    """[clips, 1, mel_bins, target_len] fp32 numpy: the mel front end runs
    on ``device`` and the clips come back to the host, where the collator
    stacks them."""
    return audio_to_mel_clips(load_wav(audio_file), device=device
                              ).cpu().numpy()


class AVSObject(SegDataset):
    """S4 single-source (reference avsbench.py:59-296)."""

    def __init__(self, root_dir: str, split: str = "train",
                 csv_file: str = "s4_meta_data.csv",
                 convert_classname: bool = True,
                 original_resolution: bool = True, itisseg: bool = False,
                 multi_modality: bool = False, device="cuda"):
        super().__init__(retry_bad=split == "train")
        self.device = device
        self.root = root_dir
        self.split = split
        self.itisseg = itisseg
        self.multi_modality = multi_modality
        self.convert_classname = convert_classname
        frames = ("visual_frames_original_resolution" if original_resolution
                  else "visual_frames")
        self.image_subdir = os.path.join("s4_data", frames)
        self.audio_subdir = os.path.join("s4_data", "audio_wav")
        self.mask_subdir = os.path.join("s4_data", "gt_masks")
        with open(os.path.join(root_dir, csv_file)) as f:
            rows = list(csv.reader(f))
        header = rows[0]
        sid = header.index("split") if "split" in header else 3
        self.rows = [r for r in rows[1:] if r and r[sid] == split]
        self.frames_per_video = 1 if split == "train" else 5

    def __len__(self):
        return len(self.rows) * self.frames_per_video

    def _get(self, index):
        row = self.rows[index // self.frames_per_video]
        video_name, category = row[0], row[2]
        frame_id = 1 if self.split == "train" else index % 5 + 1
        image_file = os.path.join(self.root, self.image_subdir, self.split,
                                  category, video_name,
                                  f"{video_name}_{frame_id}.png")
        audio_file = os.path.join(self.root, self.audio_subdir, self.split,
                                  category, f"{video_name}.wav")
        mask_file = os.path.join(self.root, self.mask_subdir, self.split,
                                 category, video_name,
                                 f"{video_name}_{frame_id}.png")
        image = load_image_rgb(image_file)
        mask = load_mask_png(mask_file)
        mels = _mel_clips(audio_file, self.device)
        name = (AVS_CATEGORY_TO_CLASS.get(category, category)
                if self.convert_classname else category)
        q = audio_ref_question()
        if self.multi_modality:
            q = q.replace("the following audio ",
                          f"the following audio {name} with ")
        a = "it is [SEG]." if self.itisseg else f"{name}[SEG]."
        return self.make_sample(image, q, a, mask[None],
                                file_name=image_file, audio_mels=mels,
                                gt_classes=[name], video_name=video_name)


class AVSMulti(SegDataset):
    """MS3 multi-source (reference avsbench.py:299-535): 5 frames per video
    in every split; no class names -> 'it is [SEG].'"""

    def __init__(self, root_dir: str, split: str = "train",
                 csv_file: str = "ms3_meta_data.csv", device="cuda"):
        super().__init__(retry_bad=split == "train")
        self.device = device
        self.root = root_dir
        self.split = split
        self.image_subdir = os.path.join("ms3_data", "visual_frames")
        self.audio_subdir = os.path.join("ms3_data", "audio_wav")
        self.mask_subdir = os.path.join("ms3_data", "gt_masks")
        with open(os.path.join(root_dir, csv_file)) as f:
            rows = list(csv.reader(f))
        header, body = rows[0], rows[1:]
        sid = header.index("split") if "split" in header else 1
        self.rows = [r for r in body if r and r[sid] == split]

    def __len__(self):
        return len(self.rows) * 5

    def _get(self, index):
        row = self.rows[index // 5]
        video_name = row[0]
        frame_id = index % 5 + 1
        image_file = os.path.join(self.root, self.image_subdir,
                                  video_name, f"{video_name}_{frame_id}.png")
        audio_file = os.path.join(self.root, self.audio_subdir,
                                  f"{video_name}.wav")
        mask_file = os.path.join(self.root, self.mask_subdir, video_name,
                                 f"{video_name}_{frame_id}.png")
        image = load_image_rgb(image_file)
        mask = load_mask_png(mask_file)
        mels = _mel_clips(audio_file, self.device)
        return self.make_sample(image, audio_ref_question(), "it is [SEG].",
                                mask[None], file_name=image_file,
                                audio_mels=mels, video_name=video_name)
