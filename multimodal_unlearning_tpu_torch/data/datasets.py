"""Dataset policies for the CLEAR unlearning recipe: the port's copy of
``multimodal_unlearning_tpu/data/datasets.py``.

- rows come from the built-in synthetic CLEAR generator
  (``synthetic:n_persons=..,qa_per_person=..``); a local HF-datasets
  directory or a hub name needs the ``datasets`` package and raises;
- ``MMMixedForgetDataset`` gives the per-loss return pairs, the random
  retain pairing, the idk answer substitution and SKU's K=3 random
  construction, with the same ``random.Random`` seeding and order of draws
  as the JAX package, so both give the same samples.
"""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np

IMAGE_CAPTION_QUESTIONS = [
    "What can you see in this picture?",
    "Tell me about the content of this image",
    "Can you give a description of the image?",
    "What is depicted in the image?",
    "Explain what you observe in the picture.",
    "Describe the image in detail.",
    "What is the main subject of this image?",
    "Can you describe the scene or objects in the image?",
    "What is happening in this image?",
]

FACEREC_QUESTION = "The name of the person on the image is "

QUESTION_STRATEGIES = ("random_caption", "random_faces", "column")

_IDK_FILE = Path(__file__).resolve().parent / "idontknow.txt"


def load_idk_answers() -> list[str]:
    """Refusal corpus (reference reads raw lines incl. trailing newline:
    mm/dataset.py:222-223 — replicated)."""
    with open(_IDK_FILE) as f:
        return f.readlines()


# ---------------------------------------------------------------------------
# Row sources
# ---------------------------------------------------------------------------


class SyntheticClearData:
    """Deterministic synthetic CLEAR-like corpus for tests and benchmarks.

    Persons with names, QA pairs, captions, images (procedural RGB blobs),
    plus the eval-side columns (paraphrased/perturbed captions and names).
    """

    def __init__(self, n_persons: int = 10, qa_per_person: int = 4, image_size: int = 32, seed: int = 0):
        self.n_persons = n_persons
        self.qa_per_person = qa_per_person
        self.image_size = image_size
        self.seed = seed

    def _image(self, pid: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1000 + pid)
        base = rng.integers(0, 255, (4, 4, 3), np.uint8)
        img = np.kron(base, np.ones((self.image_size // 4, self.image_size // 4, 1), np.uint8))
        return img.astype(np.uint8)

    def rows(self, kind: str) -> list[dict]:
        rows = []
        for pid in range(self.n_persons):
            name = f"Person{pid:03d}"
            img = self._image(pid)
            cap = f"A portrait photo of {name} wearing outfit number {pid}."
            for q in range(self.qa_per_person):
                if kind == "image_caption":
                    rows.append(
                        {
                            "image": img,
                            "caption": cap,
                            "name": name,
                            "question": f"Who is shown in photo {q}?",
                            "answer": name,
                            # a NEAR-paraphrase of the training caption: a
                            # trained model must score it above the
                            # format-exact wrong-name perturbations, so the
                            # truth ratio exceeds 1 on known persons (a
                            # structurally-alien paraphrase pins the
                            # "Truth Ratio <task>" utility factor at 0 —
                            # degenerate Model Utility at any scale)
                            "paraphrased_caption": f"A portrait picture of {name} wearing outfit number {pid}.",
                            "perturbed_captions": [
                                f"A portrait photo of Person{(pid + d) % self.n_persons:03d} wearing outfit number {(pid + d) % self.n_persons}."
                                for d in (1, 2, 3)
                            ],
                            "perturbed_names": [
                                f"Person{(pid + d) % self.n_persons:03d}" for d in (1, 2, 3)
                            ],
                            "options": [name] + [f"Person{(pid + d) % self.n_persons:03d}" for d in (1, 2)],
                        }
                    )
                else:  # text QA
                    rows.append(
                        {
                            "image": None,
                            "caption": None,
                            "name": name,
                            "question": f"What is fact {q} about {name}?",
                            "answer": f"{name} enjoys activity number {q}.",
                            "paraphrased_answer": f"{name} enjoys doing activity number {q}.",  # near-paraphrase (see above)
                            "perturbed_answers": [
                                f"{name} enjoys activity number {q + d}." for d in (1, 2, 3)
                            ],
                        }
                    )
        return rows

    def split(self, split: str) -> list[dict]:
        """CLEAR split algebra: full/forgetNN/retainNN (+tofu mixes text QA)."""
        base = split.replace("+tofu", "")
        mixed = "+tofu" in split
        img_rows = self.rows("image_caption")
        txt_rows = self.rows("text")
        n = len(img_rows)

        if base in ("full", "train"):
            sel = img_rows
        elif base.startswith("forget"):
            pct = int("".join(c for c in base if c.isdigit()) or 10)
            k = max(1, n * pct // 100)
            sel = img_rows[:k]
            if "perturbed" in split:
                sel = sel
        elif base.startswith("retain"):
            pct = int("".join(c for c in base if c.isdigit()) or 90)
            k = max(1, n * (100 - pct) // 100)
            sel = img_rows[k:]
        elif base in ("real_faces", "real_world", "retain_perturbed", "forget10_perturbed"):
            sel = img_rows[: max(1, n // 3)]
        else:
            sel = img_rows
        if mixed:
            sel = sel + txt_rows[: len(sel)]
        return [dict(r, index=i) for i, r in enumerate(sel)]


def resolve_rows(data_path: str, split: str | None) -> list[dict]:
    """Rows of a ``synthetic`` / ``synthetic:k=v,..`` spec.  A local
    HF-datasets directory or a hub name needs the ``datasets`` package,
    which the port does not use yet: it raises."""
    if data_path.startswith("synthetic"):
        cfg = {}
        if ":" in data_path:
            for kv in data_path.split(":", 1)[1].split(","):
                if "=" in kv:
                    k, v = kv.split("=")
                    cfg[k] = int(v)
        return SyntheticClearData(**cfg).split(split or "full")
    raise NotImplementedError(
        f"data path {data_path!r}: reading a local HF-datasets directory or a hub dataset "
        "needs the `datasets` package, which the port does not use yet (synthetic: only)")


# ---------------------------------------------------------------------------
# Dataset policies (reference mm/dataset.py)
# ---------------------------------------------------------------------------


class MMDatasetQA:
    """QA with image (mm/dataset.py:54-84)."""

    def __init__(self, data_path, split=None, question_key="question", answer_key="answer", image_key="image"):
        self.rows_ = resolve_rows(data_path, split)
        self.qk, self.ak, self.ik = question_key, answer_key, image_key

    def __len__(self):
        return len(self.rows_)

    def __getitem__(self, idx):
        itm = self.rows_[idx]
        return {"question": itm[self.qk], "answer": itm[self.ak], "image": itm[self.ik], "idx": itm["index"]}


class ImageCaptioningDataset:
    """Captioning with 3 question strategies (mm/dataset.py:87-141)."""

    def __init__(
        self, data_path, split=None, caption_key="caption", image_key="image",
        question_strategy="random_caption", question_key=None, seed: int = 0,
    ):
        if question_strategy not in QUESTION_STRATEGIES:
            raise ValueError(f"Unknown question_strategy: {question_strategy}")
        if question_strategy == "column" and question_key is None:
            raise ValueError("question_key required for strategy 'column'")
        self.rows_ = resolve_rows(data_path, split)
        self.ck, self.ik, self.qk = caption_key, image_key, question_key
        self.question_strategy = question_strategy
        self.seed = seed

    def __len__(self):
        return len(self.rows_)

    def _question(self, itm, rng):
        if self.question_strategy == "random_caption":
            return rng.choice(IMAGE_CAPTION_QUESTIONS)
        if self.question_strategy == "random_faces":
            return FACEREC_QUESTION
        return itm[self.qk]

    def __getitem__(self, idx):
        # stateless per-(seed, idx) draw — see MMMixedForgetDataset
        rng = random.Random(self.seed * 1_000_003 + idx)
        itm = self.rows_[idx]
        cap = itm[self.ck]
        if isinstance(cap, list):
            return [
                {"idx": itm["index"], "image": itm[self.ik], "answer": c, "question": self._question(itm, rng)}
                for c in cap
            ]
        return {"idx": itm["index"], "image": itm[self.ik], "answer": cap, "question": self._question(itm, rng)}


class MMMixedDataset:
    """Image→caption vs text→QA routing by null image (mm/dataset.py:144-180)."""

    def __init__(self, data_path, split=None, caption_key="caption", image_key="image",
                 question_key="question", answer_key="answer", seed: int = 0):
        self.rows_ = resolve_rows(data_path, split)
        self.ik, self.ck, self.qk, self.ak = image_key, caption_key, question_key, answer_key
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.rows_)

    def __getitem__(self, idx):
        itm = self.rows_[idx]
        if itm[self.ik] is None:
            return {"image": None, "question": itm[self.qk], "answer": itm[self.ak]}
        # stateless per-(seed, epoch, idx) draw — see MMMixedForgetDataset
        rng = random.Random(self.seed * 1_000_003 + self.epoch * 7919 + idx)
        return {
            "image": itm[self.ik],
            "question": rng.choice(IMAGE_CAPTION_QUESTIONS),
            "answer": itm[self.ck],
        }


class MMMixedForgetDataset:
    """Per-loss {forget, retain, idk, random} pair policy (mm/dataset.py:183-280)."""

    def __init__(
        self, forget_data_path, retain_data_path, forget_loss, retain_split, forget_split,
        caption_key="caption", image_key="image", question_key="question", answer_key="answer",
        seed: int = 0, idk_fix: bool = False,
    ):
        from multimodal_unlearning_tpu_torch.train.losses import batch_return_pairs

        self.return_pairs = batch_return_pairs(forget_loss)
        self.forget_rows = resolve_rows(forget_data_path, forget_split)
        self.retain_rows = resolve_rows(retain_data_path, retain_split)
        self.ik, self.ck, self.qk, self.ak = image_key, caption_key, question_key, answer_key
        self.seed = seed
        self.epoch = 0
        # mm/dataset.py:266 builds idk_itm (substituted answer) then formats
        # forget_itm anyway — the reference's MM idk split IS the forget
        # split.  Default replicates that (quirk-flag convention, like
        # dpo_fix); idk_fix=True formats the substituted item — the NLP
        # stack's behavior (nlp/data_module.py:87-90).
        self.idk_fix = idk_fix
        self.idk_answers = load_idk_answers() if "idk" in self.return_pairs else None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.forget_rows)

    @staticmethod
    def _format_pair(itm, rng, ik, ck, qk, ak):
        if itm.get(ik) is None:
            return {"image": None, "question": itm[qk], "answer": itm[ak]}
        return {
            "image": itm[ik],
            "question": rng.choice(IMAGE_CAPTION_QUESTIONS),
            "answer": itm[ck],
        }

    def __getitem__(self, idx):
        # Per-sample randomness is a pure function of (seed, epoch, idx) — a
        # fresh process replays identical samples after a preemption resume
        # (the torch reference instead checkpoints the global torch RNG state,
        # nlp/grad_proj.py:271-321; statelessness is the equivalent guarantee
        # and is also immune to loader-order and multi-worker effects).
        rng = random.Random(self.seed * 1_000_003 + self.epoch * 7919 + idx)
        fmt = lambda itm: self._format_pair(itm, rng, self.ik, self.ck, self.qk, self.ak)
        forget_itm = self.forget_rows[idx]
        retain_itm = self.retain_rows[rng.randint(0, len(self.retain_rows) - 1)]
        res = {}
        if "retain" in self.return_pairs:
            res["retain"] = fmt(retain_itm)
        if "forget" in self.return_pairs:
            res["forget"] = fmt(forget_itm)
        if "idk" in self.return_pairs:
            # two rng draws happen regardless of the flag so the stream (and
            # thus every other split) is flag-independent
            idk_itm = dict(forget_itm)
            idk_itm[self.ak] = rng.choice(self.idk_answers)
            idk_itm[self.ck] = rng.choice(self.idk_answers)
            res["idk"] = fmt(idk_itm if self.idk_fix else forget_itm)
        if "random" in self.return_pairs:
            K = 3
            question = res["forget"]["question"]
            random_idxs = rng.sample(range(len(self.forget_rows)), min(K, len(self.forget_rows)))
            random_itms = [dict(self.forget_rows[i]) for i in random_idxs]
            for itm in random_itms:
                itm[self.qk] = question
            res["random"] = [fmt(i) for i in random_itms]
        return res
