"""Binary manifests (port of masr_tpu/data/binary.py): the manifest's
JSON lines as length-prefixed UTF-8 records in `<manifest>.data`
(a little-endian u32 length, then the bytes) and their u64 offsets in
`<manifest>.header`, read back at random through mmap. The files are
byte for byte masr_tpu's."""
import json
import mmap
import os
import struct


class DatasetWriter(object):
    """Write manifest entries as length-prefixed UTF-8 JSON records."""

    def __init__(self, prefix):
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        self.data_f = open(prefix + ".data", "wb")
        self.header_f = open(prefix + ".header", "wb")
        self.offset = 0
        self.count = 0

    def add_data(self, data: str):
        raw = data.encode("utf-8")
        self.data_f.write(struct.pack("<I", len(raw)))
        self.data_f.write(raw)
        self.header_f.write(struct.pack("<Q", self.offset))
        self.offset += 4 + len(raw)
        self.count += 1

    def close(self):
        self.data_f.close()
        self.header_f.close()


class DatasetReader(object):
    """mmap-backed random access over records written by DatasetWriter,
    the entries filtered by duration."""

    def __init__(self, data_path, min_duration=0.0,
                 max_duration=float("inf")):
        prefix = data_path[:-5] if data_path.endswith(".data") else data_path
        self.data_file = open(prefix + ".data", "rb")
        self.mm = mmap.mmap(self.data_file.fileno(), 0,
                            access=mmap.ACCESS_READ)
        with open(prefix + ".header", "rb") as f:
            raw = f.read()
        self.offsets = [struct.unpack_from("<Q", raw, i)[0]
                        for i in range(0, len(raw), 8)]
        self.keys = [i for i, off in enumerate(self.offsets)
                     if max_duration >= self._read_at(off)["duration"]
                     >= min_duration]

    def _read_at(self, offset):
        (n,) = struct.unpack_from("<I", self.mm, offset)
        return json.loads(self.mm[offset + 4: offset + 4 + n].decode("utf-8"))

    def get_data(self, idx):
        return self._read_at(self.offsets[self.keys[idx]])

    def get_keys(self):
        return list(self.keys)

    def __len__(self):
        return len(self.keys)

    def close(self):
        self.mm.close()
        self.data_file.close()


def create_manifest_binary(train_manifest_path, test_manifest_path):
    """Write `<manifest>.data` and `<manifest>.header` beside each JSONL
    manifest."""
    for path in [train_manifest_path, test_manifest_path]:
        writer = DatasetWriter(path)
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    writer.add_data(line)
        writer.close()
