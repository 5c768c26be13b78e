"""Manifest reading (port of masr_tpu/data/manifest.py:19 read_manifest).

A manifest is JSONL, one utterance per line: {"audio_filepath",
"duration", "text"}, optionally with start_time / end_time (a slice of a
long file). Writing manifests (create_data) is not ported.
"""
import json


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
