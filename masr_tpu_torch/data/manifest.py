"""Manifest utilities (port of masr_tpu/data/manifest.py: read_manifest :19,
is_ustr :37, _normalize_text :48, create_manifest :58, _write_jsonl :121,
merge_audio :128, change_rate :187, create_noise_manifest :196,
count_manifest :214, build_vocab :222).

A manifest is JSONL, one utterance per line: {"audio_filepath",
"duration", "text"}, optionally with start_time / end_time (a slice of a
long file) or start_frame / end_frame (a row range of a precomputed
feature slab, MASRTrainer.extract_features). What this module writes is
masr_tpu's byte for byte: the same sorting, the same test split and the
same `json.dumps(..., ensure_ascii=False)` lines. zhconv (traditional →
simplified Chinese) is optional, as there.
"""
import json
import os

import numpy as np

from masr_tpu_torch.audio import AudioSegment
from masr_tpu_torch.utils.logger import setup_logger

logger = setup_logger()


def read_manifest(manifest_path, max_duration=float("inf"), min_duration=0.0):
    """→ the entries whose duration is in [min_duration, max_duration]."""
    manifest = []
    with open(manifest_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            if max_duration >= entry["duration"] >= min_duration:
                manifest.append(entry)
    return manifest


def _is_cjk(ch):
    return "一" <= ch <= "鿿"


def is_ustr(text):
    """Only the CJK and the ASCII letters, digits, spaces and apostrophes
    of text."""
    return "".join(ch for ch in text if _is_cjk(ch) or ch.isascii() and (
        ch.isalnum() or ch in " '"))


def _normalize_text(text, to_simplified=True):
    text = text.lower().strip()
    if to_simplified:
        try:
            import zhconv
            text = zhconv.convert(text, "zh-cn")
        except ImportError:
            pass  # optional: traditional → simplified conversion
    return is_ustr(text)


def create_manifest(annotation_path, train_manifest_path, test_manifest_path,
                    is_change_frame_rate=True, target_sr=16000,
                    only_keep_zh_en=True, max_test_manifest=10000):
    """The train and test manifests of every annotation file under
    annotation_path (sorted by name), each sorted by duration (sortagrad).
    A .txt line is `<audio path>\\t<text>`; a .json line a JSONL entry with
    audio_filepath and text (start_time / end_time optional). A file named
    test.* goes to the test manifest; without one, the shortest 1/20 of the
    utterances (at least 1, at most max_test_manifest) do.
    is_change_frame_rate rewrites each audio file at target_sr in place."""
    data_list, test_list, durations = [], [], []
    for annotation_text in sorted(os.listdir(annotation_path)):
        path = os.path.join(annotation_path, annotation_text)
        is_test = annotation_text.startswith("test.")
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                if annotation_text.endswith(".json"):
                    entry = json.loads(line)
                    audio_path, text = entry["audio_filepath"], entry["text"]
                    start_time = entry.get("start_time")
                    end_time = entry.get("end_time")
                else:
                    audio_path, text = line.split("\t", 1)
                    start_time = end_time = None
                if is_change_frame_rate:
                    change_rate(audio_path, target_sr)
                if start_time is not None:
                    duration = round(float(end_time) - float(start_time), 3)
                else:
                    duration = round(AudioSegment.from_file(
                        audio_path).duration, 3)
                text = _normalize_text(text) if only_keep_zh_en \
                    else text.lower().strip()
                if len(text) == 0:
                    continue
                entry = {"audio_filepath": audio_path.replace("\\", "/"),
                         "duration": duration, "text": text}
                if start_time is not None:
                    entry["start_time"] = float(start_time)
                    entry["end_time"] = float(end_time)
                durations.append(duration)
                (test_list if is_test else data_list).append(entry)
            except Exception as e:
                logger.warning(f"skipping bad annotation line ({e}): "
                               f"{line[:120]}")
    data_list.sort(key=lambda e: e["duration"])
    test_list.sort(key=lambda e: e["duration"])
    if not test_list and data_list:
        n_test = max(1, min(max_test_manifest, len(data_list) // 20))
        test_list = data_list[:n_test]
        data_list = data_list[n_test:]
    _write_jsonl(train_manifest_path, data_list)
    _write_jsonl(test_manifest_path, test_list)
    logger.info(f"created manifests: {len(data_list)} train / "
                f"{len(test_list)} test utterances, total "
                f"{sum(durations) / 3600:.2f} h")


def _write_jsonl(path, entries):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for e in entries:
            f.write(json.dumps(e, ensure_ascii=False) + "\n")


def merge_audio(annotation_path, save_audio_path, max_duration=600,
                target_sr=16000, remove_original=False):
    """Packs the utterances of each non-test .txt annotation file into wavs
    of at least max_duration seconds (the last one shorter) under
    save_audio_path, `<name>_<i>.wav`, and writes `<name>.merge.json`
    beside the annotation: JSONL entries with start_time / end_time into
    the merged files. remove_original deletes the .txt annotation (so that
    create_manifest does not count it twice); the source audio is kept."""
    os.makedirs(save_audio_path, exist_ok=True)
    for annotation_text in sorted(os.listdir(annotation_path)):
        if not annotation_text.endswith(".txt") or \
                annotation_text.startswith("test"):
            continue
        path = os.path.join(annotation_path, annotation_text)
        stem = os.path.splitext(annotation_text)[0]
        out_entries = []
        buf, pending, file_idx = [], [], 0

        def flush():
            nonlocal buf, pending, file_idx
            if not buf:
                return
            merged_path = os.path.join(
                save_audio_path, f"{stem}_{file_idx}.wav").replace("\\", "/")
            AudioSegment(np.concatenate(buf), target_sr).to_wav_file(
                merged_path)
            t = 0.0
            for dur, text in pending:
                out_entries.append({"audio_filepath": merged_path,
                                    "duration": round(dur, 3), "text": text,
                                    "start_time": round(t, 3),
                                    "end_time": round(t + dur, 3)})
                t += dur
            buf, pending = [], []
            file_idx += 1

        buf_dur = 0.0
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                audio_path, text = line.split("\t", 1)
                try:
                    seg = AudioSegment.from_file(audio_path)
                except Exception as e:
                    logger.warning(f"merge_audio: skipping {audio_path}: {e}")
                    continue
                if seg.sample_rate != target_sr:
                    seg.resample(target_sr)
                buf.append(seg.samples)
                pending.append((seg.duration, text))
                buf_dur += seg.duration
                if buf_dur >= max_duration:
                    flush()
                    buf_dur = 0.0
        flush()
        _write_jsonl(os.path.join(annotation_path, stem + ".merge.json"),
                     out_entries)
        if remove_original:
            os.remove(path)
        logger.info(f"merged {annotation_text}: {len(out_entries)} "
                    f"utterances into {file_idx} files")


def change_rate(audio_path, target_sr=16000):
    """Rewrites an audio file at target_sr when it has another rate."""
    seg = AudioSegment.from_file(audio_path)
    if seg.sample_rate != target_sr:
        seg.resample(target_sr)
        seg.to_wav_file(audio_path)


def create_noise_manifest(noise_dir, noise_manifest_path):
    """A manifest of the .wav / .flac files in noise_dir (empty text),
    sorted by name; an absent directory gives an empty manifest."""
    entries = []
    if os.path.isdir(noise_dir):
        for name in sorted(os.listdir(noise_dir)):
            if not name.lower().endswith((".wav", ".flac")):
                continue
            path = os.path.join(noise_dir, name)
            try:
                seg = AudioSegment.from_file(path)
                entries.append({"audio_filepath": path.replace("\\", "/"),
                                "duration": round(seg.duration, 3),
                                "text": ""})
            except Exception as e:
                logger.warning(f"skipping noise file {path}: {e}")
    _write_jsonl(noise_manifest_path, entries)
    logger.info(f"created noise manifest with {len(entries)} files")


def count_manifest(counter, manifest_path):
    """Adds each character of the manifest's texts to counter (a dict)."""
    for entry in read_manifest(manifest_path):
        for ch in entry["text"]:
            counter[ch] = counter.get(ch, 0) + 1


def build_vocab(vocab_path, manifest_paths, count_threshold=2):
    """The vocabulary file: `<blank>`, `<unk>`, then the characters by
    falling count (ties in first-seen order) down to count_threshold, a
    space as `<space>`, then `<eos>`; each line `<token>\\t<count>`."""
    counter = {}
    for p in manifest_paths:
        count_manifest(counter, p)
    items = sorted(counter.items(), key=lambda kv: kv[1], reverse=True)
    os.makedirs(os.path.dirname(vocab_path) or ".", exist_ok=True)
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write("<blank>\t-1\n<unk>\t-1\n")
        for ch, count in items:
            if count < count_threshold:
                continue
            f.write(f"{'<space>' if ch == ' ' else ch}\t{count}\n")
        f.write("<eos>\t-1\n")
    logger.info(f"wrote vocabulary to {vocab_path}")
