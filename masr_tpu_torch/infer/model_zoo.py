"""Pretrained-model registry + cache (port of masr_tpu/infer/model_zoo.py;
parity surface: predict.py:42-58 — `model_tag` auto-download and unzip
into the user cache).

The registry maps tag → bundle URL. Published masr_tpu bundles can be
registered here or at runtime via `register_model`; both packages read
one bundle format, so the port shares masr_tpu's cache directory.
Reference-MASR checkpoints are converted with
tools/convert_masr_checkpoint.py.
"""
import os
import urllib.request
import zipfile

from masr_tpu_torch.utils.logger import setup_logger

logger = setup_logger()

CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache", "masr_tpu",
                         "models")

# tag → bundle zip URL (populate as bundles are published)
MODEL_URLS = {}

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# tags shipped INSIDE the repo (no download): tag → bundle directory.
# tiny_zh_synth is the example bundle — a d=48 2-block streaming
# conformer trained through the real CLI pipeline on the in-repo
# synthetic-TTS corpus (examples/tiny_zh_synth/README.md) — it makes the
# `MASRPredictor(model_tag=...)` one-liner work offline and doubles as a
# decode-regression golden (tests/test_example_bundle.py).
BUILTIN_MODELS = {
    "tiny_zh_synth": os.path.join(_REPO_ROOT, "examples", "tiny_zh_synth",
                                  "inference_model"),
}


def register_model(tag, url):
    MODEL_URLS[tag] = url


def get_model_dir(model_tag):
    """Resolve a model tag to a local bundle directory: in-repo builtin
    tags first, then the user cache, then download-and-unpack."""
    builtin = BUILTIN_MODELS.get(model_tag)
    if builtin and os.path.exists(os.path.join(builtin, "inference.json")):
        return builtin
    target = os.path.join(CACHE_DIR, model_tag)
    bundle = os.path.join(target, "inference_model")
    if os.path.exists(os.path.join(bundle, "inference.json")):
        return bundle
    if os.path.exists(os.path.join(target, "inference.json")):
        return target
    url = MODEL_URLS.get(model_tag)
    if url is None:
        known = sorted(set(MODEL_URLS) | set(BUILTIN_MODELS))
        raise ValueError(
            f"unknown model_tag '{model_tag}' and no cached copy in "
            f"{target}; known tags: {known or '(none)'} — "
            f"register one with masr_tpu_torch.infer.model_zoo."
            f"register_model or "
            f"convert a reference checkpoint with "
            f"tools/convert_masr_checkpoint.py")
    os.makedirs(target, exist_ok=True)
    zip_path = os.path.join(target, "bundle.zip")
    logger.info(f"downloading {url} → {zip_path}")
    with urllib.request.urlopen(url) as src, open(zip_path, "wb") as out:
        while True:
            buf = src.read(1 << 15)
            if not buf:
                break
            out.write(buf)
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(target)
    os.remove(zip_path)
    if os.path.exists(os.path.join(bundle, "inference.json")):
        return bundle
    if os.path.exists(os.path.join(target, "inference.json")):
        return target
    raise RuntimeError(f"downloaded bundle for {model_tag} is malformed")
