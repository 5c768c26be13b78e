"""Punctuation restoration (port of masr_tpu/infer/punctuation.py; the
parity surface: masr/infer_utils/pun_predictor.py:16-117 — an ERNIE
token classifier behind paddle-inference in the reference; SURVEY.md
§2.12 marks the paddle sidecar optional).

Three in-repo tiers, best available wins:
 1. a `punctuation.py` plugin in the model dir (`Predictor(model_dir)`
    exposing `__call__(text) -> text`) — bring-your-own model;
 2. a transformers token-classification checkpoint dir (torch CPU) —
    the ERNIE-pipeline equivalent (clean → tokenize → classify →
    re-insert, pun_predictor.py:63-117);
 3. `RulePunctuation` — a dependency-free rule-based restorer
    (sentence-final particles, conjunction boundaries, length capping),
    used when no model_dir is given so `use_pun=True` always works.
"""
import os
import re

# sentence-final question particles → ？
_QUESTION_FINALS = "吗嘛么呢"
# other sentence-final particles → 。 (statement)
_STATEMENT_FINALS = "吧啊呀啦哦喔嘞咯"
# conjunctions that open a clause: a comma goes BEFORE them
_CONJUNCTIONS = ("但是", "可是", "不过", "然后", "所以", "因此", "而且",
                 "并且", "如果", "虽然", "因为", "否则", "接着", "后来",
                 "还有", "另外", "于是", "结果", "要不然")
# characters a length-capped comma may follow (clause-final particles)
_BREAKABLE = set("了的地得着过吧呢啊")
_PUNCT = set("，。？！、；：,.!?;: ")


class RulePunctuation(object):
    """Rule-based Chinese/English punctuation restorer.

    Deliberately conservative: clause commas only before known
    conjunctions or after clause-final particles when a run grows past
    `max_run` chars; terminal mark chosen from final particles. Already-
    punctuated text passes through untouched.
    """

    def __init__(self, max_run=20):
        self.max_run = max_run

    def __call__(self, text):
        if not text:
            return text
        if any(c in _PUNCT for c in text):
            return text  # already punctuated (or spaced English)
        if re.fullmatch(r"[A-Za-z0-9']+", text):
            return text[0].upper() + text[1:] + "."
        out = []
        run = 0
        i = 0
        n = len(text)
        while i < n:
            # comma before a clause-opening conjunction (not at start)
            if run >= 4:
                for conj in _CONJUNCTIONS:
                    if text.startswith(conj, i):
                        out.append("，")
                        run = 0
                        break
            out.append(text[i])
            run += 1
            # length cap: break after a clause-final particle
            if run >= self.max_run and text[i] in _BREAKABLE and i < n - 1:
                out.append("，")
                run = 0
            i += 1
        last = text[-1]
        if last in _QUESTION_FINALS:
            out.append("？")
        elif last in _STATEMENT_FINALS:
            out.append("。")
        else:
            out.append("。")
        return "".join(out)


class PunctuationPredictor(object):
    def __init__(self, model_dir=None):
        self._impl = None
        if model_dir is None:
            self._impl = RulePunctuation()
            return
        plugin = os.path.join(model_dir, "punctuation.py")
        if os.path.exists(plugin):
            import importlib.util
            spec = importlib.util.spec_from_file_location("pun_plugin", plugin)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._impl = mod.Predictor(model_dir)
            return
        # transformers token-classifier (torch CPU), imported only here
        from transformers import AutoModelForTokenClassification, AutoTokenizer
        import torch
        self._tokenizer = AutoTokenizer.from_pretrained(model_dir)
        self._model = AutoModelForTokenClassification.from_pretrained(model_dir)
        self._model.eval()
        self._torch = torch
        self._id2label = dict(self._model.config.id2label)

    def __call__(self, text):
        if self._impl is not None:
            return self._impl(text)
        if not text:
            return text
        torch = self._torch
        enc = self._tokenizer(list(text), is_split_into_words=True,
                              return_tensors="pt")
        with torch.no_grad():
            logits = self._model(**enc).logits[0]
        pred = logits.argmax(-1).tolist()
        out = []
        seen = set()
        word_ids = enc.word_ids()
        for i, wid in enumerate(word_ids):
            if wid is None or wid in seen:  # specials / wordpiece tails
                continue
            seen.add(wid)
            out.append(text[wid])
            label = str(self._id2label.get(pred[i], "O"))
            if label not in ("O", "0"):
                out.append(label)
        return "".join(out)
