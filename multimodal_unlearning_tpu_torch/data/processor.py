"""Prompt formatting, image-token expansion and image preprocessing for
serving: the port's copy of the parts of
``multimodal_unlearning_tpu/data/processor.py`` that a request goes through
(the llava chat template, ``MMProcessor.format`` / ``_encode_expand`` and
``preprocess_image``)."""

from __future__ import annotations

import numpy as np

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
    inputs take the CLIPImageProcessor path; float inputs (synthetic pixels
    in [0, 1]) are resized directly to square."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3:
        return preprocess_image_hf(arr, image_size)
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


class MMProcessor:
    """Chat formatting and image-token expansion of a request's prompt."""

    def __init__(self, tokenizer, *, image_size: int = 336, num_image_tokens: int = 576,
                 chat_template: str = "llava", tags: dict | None = None):
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.num_image_tokens = num_image_tokens
        self.template = CHAT_TEMPLATES.get(chat_template)
        self.tags = tags

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
