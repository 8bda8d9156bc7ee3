"""Prompt formatting, tokenization, image preprocessing and collation: the
port's copy of ``multimodal_unlearning_tpu/data/processor.py`` (the llava
chat template and the tagged text families).

- ``<image>`` expands to ``num_image_tokens`` copies in the collator, so the
  model's splice is a masked gather;
- labels are -100 on the question tokens and on padding, the question count
  taken in expanded token space (``hf_question_count_quirk=True`` counts the
  unexpanded ``<image>`` as HF's collator does);
- padding: left (the reference's default) or right, to the longest row
  rounded up to ``pad_multiple``;
- uint8 images take CLIPImageProcessor's arithmetic, through the native
  library when it loads (``utils/native.py``), else through PIL.

Qwen2-VL's patch layout (``vision_mode="qwen2vl"``) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from multimodal_unlearning_tpu_torch.utils.native import clip_preprocess_batch, pad_and_mask

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def format_llava(question: str, answer: str | None, has_image: bool):
    """llava chat template (configs/model_config.yaml:63 semantics)."""
    q = "USER: " + ("<image>\n" if has_image else "") + question + " "
    if answer is None:
        return q + "ASSISTANT:"
    return q + "ASSISTANT: " + answer + " "


def format_tagged(question: str, answer: str | None, tags: dict):
    """Text families: question_start_tag / question_end_tag / answer_tag."""
    q = tags["question_start_tag"] + question + tags["question_end_tag"] + tags.get("answer_tag", "")
    if answer is None:
        return q
    return q + answer


CHAT_TEMPLATES = {"llava": format_llava}


def preprocess_image_hf(arr: np.ndarray, image_size: int) -> np.ndarray:
    """CLIPImageProcessor's path for uint8 RGB arrays: shortest-edge bicubic
    resize (PIL), center crop, rescale, normalize."""
    from PIL import Image

    h, w = arr.shape[:2]
    short, long_ = (h, w) if h <= w else (w, h)
    nl = int(image_size * long_ / short)
    nh, nw = (image_size, nl) if h <= w else (nl, image_size)
    if (nh, nw) != (h, w):
        arr = np.asarray(Image.fromarray(arr).resize((nw, nh), Image.BICUBIC))
    top = (nh - image_size) // 2
    left = (nw - image_size) // 2
    arr = arr[top:top + image_size, left:left + image_size]
    return (arr.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


def preprocess_image(img, image_size: int) -> np.ndarray:
    """-> [image_size, image_size, 3] float32, CLIP-normalized.  uint8 RGB
    inputs take the CLIPImageProcessor path (the native library's, else
    PIL's); float inputs (synthetic pixels in [0, 1]) are resized directly to
    square."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3:
        out = clip_preprocess_batch(arr[None], image_size, CLIP_MEAN, CLIP_STD)
        return out[0] if out is not None else preprocess_image_hf(arr, image_size)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[:2] != (image_size, image_size):
        from PIL import Image

        im = Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))
        im = im.resize((image_size, image_size), Image.BICUBIC)
        arr = np.asarray(im).astype(np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def _round_up(n, m):
    return (n + m - 1) // m * m


class MMProcessor:
    """Chat formatting, image-token expansion and collation."""

    def __init__(self, tokenizer, *, image_size: int = 336, num_image_tokens: int = 576,
                 chat_template: str = "llava", padding_side: str = "left",
                 pad_multiple: int = 128, hf_question_count_quirk: bool = False,
                 tags: dict | None = None, vision_mode: str = "clip"):
        if vision_mode != "clip":
            raise NotImplementedError(
                f"vision_mode {vision_mode!r}: Qwen2-VL's processor is not ported yet (other "
                "model families come later)")
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.num_image_tokens = num_image_tokens
        self.template = CHAT_TEMPLATES.get(chat_template)
        self.tags = tags
        self.padding_side = padding_side
        self.pad_multiple = pad_multiple
        self.hf_question_count_quirk = hf_question_count_quirk

    def format(self, question: str, answer: str | None, has_image: bool) -> str:
        if self.template is not None:
            return self.template(question, answer, has_image)
        return format_tagged(question, answer, self.tags or {})

    def _encode_expand(self, text: str) -> list[int]:
        ids = self.tokenizer.encode(text, add_special_tokens=True)
        img_id = getattr(self.tokenizer, "image_token_id", -1)
        out: list[int] = []
        for i in ids:
            if i == img_id:
                out.extend([img_id] * self.num_image_tokens)
            else:
                out.append(i)
        return out

    def encode_sample(self, sample: dict, max_length: int):
        """-> (ids, number of question tokens), in expanded token space."""
        has_image = sample.get("image") is not None
        q_text = self.format(sample["question"], None, has_image)
        full_text = self.format(sample["question"], sample["answer"], has_image)
        full_ids = self._encode_expand(full_text)[:max_length]
        if self.hf_question_count_quirk:
            n_q = len(self.tokenizer.encode(q_text, add_special_tokens=True))
        else:
            n_q = len(self._encode_expand(q_text))
        return full_ids, min(n_q, len(full_ids))

    def collate(self, samples: list[dict], max_length: int, *, return_indices: bool = False,
                return_answers: bool = False) -> dict:
        """A batch of numpy arrays: input_ids, attention_mask, labels (int32
        [B, S]) and pixel_values (f32 [B, H, W, 3], zeros for rows without an
        image).  ``samples`` may be a list of lists (a fixed number of
        answers per sample): the arrays then carry that number as a second
        dimension."""
        nested = isinstance(samples[0], list)
        if nested:
            list_size = len(samples[0])
            samples = [s for group in samples for s in group]

        encoded = [self.encode_sample(s, max_length) for s in samples]
        S = _round_up(max(len(ids) for ids, _ in encoded), self.pad_multiple)
        S = min(S, _round_up(max_length, self.pad_multiple))
        pad_id = self.tokenizer.pad_token_id
        B = len(samples)
        input_ids, attention_mask, labels = pad_and_mask(
            [ids for ids, _ in encoded], [n_q for _, n_q in encoded], S, pad_id,
            pad_left=self.padding_side == "left")
        pixel_values = np.zeros((B, self.image_size, self.image_size, 3), np.float32)
        for r, s in enumerate(samples):
            if s.get("image") is not None:
                pixel_values[r] = preprocess_image(s["image"], self.image_size)

        out = {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels,
               "pixel_values": pixel_values}
        if return_answers:
            ans = [self.tokenizer.encode(s["answer"]) for s in samples]
            A = max(len(a) for a in ans)
            answers = np.full((B, A), pad_id, np.int32)
            for r, a in enumerate(ans):
                answers[r, :len(a)] = a
            out["answers"] = answers
        if return_indices:
            out["indices"] = np.asarray([s["idx"] for s in samples], np.int32)
        if nested:
            out = {k: v.reshape(len(v) // list_size, list_size, *v.shape[1:])
                   for k, v in out.items()}
        return out

    def collate_forget(self, samples: list[dict], max_length: int) -> dict:
        """One collated batch per split of the forget dataset's items."""
        return {split: self.collate([s[split] for s in samples], max_length)
                for split in samples[0].keys()}
