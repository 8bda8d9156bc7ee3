"""Prompt formatting, tokenization, image preprocessing and collation: the
port's copy of ``multimodal_unlearning_tpu/data/processor.py`` (the llava
and qwen chat templates and the tagged text families).

- ``<image>`` expands to ``num_image_tokens`` copies in the collator, so the
  model's splice is a masked gather;
- labels are -100 on the question tokens and on padding, the question count
  taken in expanded token space (``hf_question_count_quirk=True`` counts the
  unexpanded ``<image>`` as HF's collator does);
- padding: left (the reference's default) or right, to the longest row
  rounded up to ``pad_multiple``;
- uint8 images take CLIPImageProcessor's arithmetic, through the native
  library when it loads (``utils/native.py``), else through PIL;
- Qwen2-VL (``vision_mode="qwen2vl"``): the image span is wrapped in
  ``vision_wrap`` (vision start, vision end) and the pixels become
  flatten-order patches [N, 3*2*P*P] (``preprocess_image_qwen``).

The qwen template writes the TOKENIZER's image placeholder
(``cli/common.build_processor`` binds it into the template).  The JAX
package's ``format_qwen`` always writes ``<image>``, which the byte
tokenizer of ``qwen-vl2-2b`` / ``qwen-vl-3b`` (image token
``<|image_pad|>``) encodes as seven bytes: its samples carry no image token,
and the image features are never spliced in.  The tiny test families use
``<image>``, where the two packages agree.
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


def format_qwen(question: str, answer: str | None, has_image: bool,
                image_token: str = "<image>"):
    """qwen chat template; ``image_token`` is the tokenizer's placeholder."""
    q = ("<|im_start|>user\n" + (image_token if has_image else "") + question
         + "<|im_end|>\n<|im_start|>assistant\n")
    if answer is None:
        return q
    return q + answer + "<|im_end|>"


def format_tagged(question: str, answer: str | None, tags: dict):
    """Text families: question_start_tag / question_end_tag / answer_tag."""
    q = tags["question_start_tag"] + question + tags["question_end_tag"] + tags.get("answer_tag", "")
    if answer is None:
        return q
    return q + answer


CHAT_TEMPLATES = {"llava": format_llava, "qwen": format_qwen}


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


def smart_resize(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 28 * 28 * 1280):
    """Qwen2VLImageProcessor's target size: both sides multiples of
    ``factor``, the pixel count within [min_pixels, max_pixels], the aspect
    kept."""
    import math

    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def qwen_patchify(arr: np.ndarray, patch_size: int = 14, merge_size: int = 2,
                  temporal: int = 2) -> np.ndarray:
    """A normalized [H, W, 3] image -> Qwen2-VL's flatten-order patches
    [grid_h * grid_w, 3 * temporal * P * P] (one image, its frame repeated
    ``temporal`` times)."""
    H, W, C = arr.shape
    gh, gw = H // patch_size, W // patch_size
    x = np.repeat(arr.transpose(2, 0, 1)[None], temporal, axis=0)  # [T, C, H, W]
    x = x.reshape(1, temporal, C, gh // merge_size, merge_size, patch_size,
                  gw // merge_size, merge_size, patch_size)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return np.ascontiguousarray(x.reshape(gh * gw, C * temporal * patch_size * patch_size))


def preprocess_image_qwen(img, image_size: int, patch_size: int = 14,
                          merge_size: int = 2) -> np.ndarray:
    """Qwen2VLImageProcessor's single-image path at a fixed resolution:
    a uint8 image is resized to ``image_size`` square (the static grid every
    batch shares; ``smart_resize``'s own target is not used) by PIL's
    bicubic filter, rescaled, CLIP-normalized and patchified ->
    [N_patches, patch_dim] f32.  A float image (values in
    [0, 1]) of another size is resized as ``preprocess_image`` resizes one,
    through 8-bit PIL bicubic; the JAX package resizes it in floats with
    ``jax.image.resize(..., "bicubic")`` there, so the two differ for such
    inputs (a float image already at ``image_size`` is not resized)."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.dtype == np.uint8:
        if arr.shape[:2] != (image_size, image_size):
            from PIL import Image

            arr = np.asarray(Image.fromarray(arr).resize((image_size, image_size),
                                                         Image.BICUBIC))
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
        if arr.shape[:2] != (image_size, image_size):
            from PIL import Image

            im = Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))
            arr = np.asarray(im.resize((image_size, image_size), Image.BICUBIC)).astype(
                np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return qwen_patchify(arr, patch_size, merge_size)


def _round_up(n, m):
    return (n + m - 1) // m * m


class MMProcessor:
    """Chat formatting, image-token expansion and collation."""

    def __init__(self, tokenizer, *, image_size: int = 336, num_image_tokens: int = 576,
                 chat_template: str = "llava", padding_side: str = "left",
                 pad_multiple: int = 128, hf_question_count_quirk: bool = False,
                 tags: dict | None = None, vision_mode: str = "clip",
                 vision_wrap: tuple | None = None, patch_size: int = 14,
                 spatial_merge_size: int = 2):
        if vision_mode not in ("clip", "qwen2vl"):
            raise NotImplementedError(
                f"vision_mode {vision_mode!r}: the port has 'clip' (LLaVA) and 'qwen2vl'")
        self.vision_mode = vision_mode
        self.vision_wrap = vision_wrap  # (vision start id, vision end id)
        self.patch_size = patch_size
        self.spatial_merge_size = spatial_merge_size
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.num_image_tokens = num_image_tokens
        # a name from CHAT_TEMPLATES, or a template with its arguments bound
        self.template = chat_template if callable(chat_template) else CHAT_TEMPLATES.get(
            chat_template)
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
            if i == img_id and self.vision_wrap is not None:  # qwen2vl: start, span, end
                out.extend([self.vision_wrap[0]] + [img_id] * self.num_image_tokens
                           + [self.vision_wrap[1]])
            elif i == img_id:
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
        [B, S]) and pixel_values (f32 [B, H, W, 3], or Qwen2-VL's patches
        [B, N, 3*2*P*P]; zeros for rows without an image).  ``samples`` may
        be a list of lists (a fixed number of answers per sample): the arrays
        then carry that number as a second dimension."""
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
        pixel_values = self.empty_pixels(B)
        for r, s in enumerate(samples):
            if s.get("image") is not None:
                pixel_values[r] = self.preprocess(s["image"])

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

    def empty_pixels(self, B: int) -> np.ndarray:
        """A zero pixel batch of this processor's layout."""
        if self.vision_mode == "qwen2vl":
            g = self.image_size // self.patch_size
            return np.zeros((B, g * g, 3 * 2 * self.patch_size ** 2), np.float32)
        return np.zeros((B, self.image_size, self.image_size, 3), np.float32)

    def preprocess(self, img) -> np.ndarray:
        """One image as the model takes it: [H, W, 3] CLIP-normalized, or
        Qwen2-VL's patches [N, patch_dim]."""
        if self.vision_mode == "qwen2vl":
            return preprocess_image_qwen(img, self.image_size, self.patch_size,
                                         self.spatial_merge_size)
        return preprocess_image(img, self.image_size)

    def collate_forget(self, samples: list[dict], max_length: int) -> dict:
        """One collated batch per split of the forget dataset's items."""
        return {split: self.collate([s[split] for s in samples], max_length)
                for split in samples[0].keys()}
