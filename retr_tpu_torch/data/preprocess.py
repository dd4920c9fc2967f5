"""Per-sample host-side preprocessing: decode -> crop -> pad -> PIL-exact resize
(retr_tpu/data/preprocess.py).

Replicates data_utils/refcoco.py:105-188 + data_utils/utils.py:161-256 semantics on
numpy arrays (the variable-size stage runs on the host; everything downstream runs
on the device at static shapes):

- integer bbox rounding with banker's round (np.round == python round semantics,
  utils.py:175);
- target region sliced out; context = full image with the bbox zeroed and its mask
  True inside the bbox (utils.py:182-192);
- pad to square (image: PIL banker's-round centering; mask: floor/ceil centering —
  the reference's one-pixel disagreement included, utils.py:231-256);
- PIL-bit-exact uint8 resize to ``image_size`` (ops.image.pil_resize_uint8);
- mask resize through torch-bilinear weights with the nonzero->True cast
  (refcoco.py:151-152 semantics);
- 5-dim relative location features (utils.py:198-228).

Output is uint8 imagery + bool masks; normalization happens on the device
(data.pipeline).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from retr_tpu_torch import native
from retr_tpu_torch.ops import image as imops


class Sample(NamedTuple):
    ann_id: int
    target_image: np.ndarray            # [S, S, 3] uint8
    target_mask: np.ndarray             # [S, S] bool
    caption_ids: np.ndarray             # [T+1] int32
    caption_mask: np.ndarray            # [T+1] bool (True = pad; inverted attention mask)
    context_image: Optional[np.ndarray] = None
    context_mask: Optional[np.ndarray] = None
    loc_feats: Optional[np.ndarray] = None


def load_image(image_path: str) -> np.ndarray:
    """Open an image file as an RGB uint8 array (reference load_image,
    eval_utils/decode.py:13-17, minus the torch transform — feed the result to
    preprocess_sample). A file that starts with NumPy's ``.npy`` magic is read
    by ``np.load`` whatever its name (the dataset asks for COCO's ``.jpg``
    names), as a uint8 HWC array; any other file needs PIL, and without it
    this raises, naming the ways around it."""
    with open(image_path, "rb") as f:
        is_npy = f.read(len(np.lib.format.MAGIC_PREFIX)) == np.lib.format.MAGIC_PREFIX
    if is_npy:
        return np.load(image_path, allow_pickle=False)
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            "decoding an image file needs PIL, which is not installed: pass the image as a uint8 HWC "
            "array, save it with np.save, or give RefCocoCaptions a read_image=<path -> uint8 HWC array>") from exc

    with Image.open(image_path) as im:
        if im.mode != "RGB":
            im = im.convert("RGB")
        return np.asarray(im)


def crop_image_to_bb(image: np.ndarray, bb, return_context: bool = False):
    """utils.py:161-195 on a [H, W, 3] uint8 array."""
    x, y, w, h = (int(round(float(v))) for v in bb)
    target = image[y : y + h, x : x + w, :].copy()
    target_mask = np.zeros(target.shape[:2], dtype=bool)
    if not return_context:
        return target, target_mask
    context = image.copy()
    context[y : y + h, x : x + w, :] = 0
    context_mask = np.zeros(image.shape[:2], dtype=bool)
    context_mask[y : y + h, x : x + w] = True
    return target, target_mask, context, context_mask


def compute_position_features(image_shape, bb) -> np.ndarray:
    """utils.py:198-228: [x1/iw, y1/ih, x2/iw, y2/ih, area_ratio] as float32."""
    ih, iw = image_shape[:2]
    x, y, w, h = (float(v) for v in bb)
    return np.array(
        [x / iw, y / ih, (x + w) / iw, (y + h) / ih, (w * h) / (iw * ih)], np.float32
    )


def _resize_stream(img_u8: np.ndarray, mask: np.ndarray, out_size: int):
    """pad-to-square + PIL-exact resize for the image; reference mask path for the
    mask. Runs in the C++ core (retr_tpu_torch.native) where it loads; the numpy
    code below is the spec it bit-matches (tests/test_torch_native.py)."""
    if native.available():
        return native.pad_resize_image(img_u8, out_size), native.pad_resize_mask(mask, out_size)

    img_sq = imops.pad_uint8_to_square(img_u8)
    img_rs = imops.pil_resize_uint8(img_sq, out_size, out_size)

    mask_sq = imops.pad_mask_to_square(mask)
    m = mask_sq.shape[0]
    w = imops.torch_bilinear_weights(m, out_size)
    mask_rs = (w @ mask_sq.astype(np.float64) @ w.T) != 0.0
    return img_rs, mask_rs


def preprocess_sample(
    image: np.ndarray,
    bbox,
    caption: str,
    tokenizer,
    *,
    ann_id: int = 0,
    image_size: int = 224,
    max_length: int = 128,
    use_global: bool = False,
    use_location: bool = False,
) -> Sample:
    """Full __getitem__ equivalent (refcoco.py:105-188). ``max_length`` is
    config.max_position_embeddings; tokenization pads/truncates to max_length+1 so the
    teacher-forced input/target slices are exactly max_length long (refcoco.py:95)."""
    enc = tokenizer.encode_plus(caption, max_length=max_length + 1, padding="max_length")
    caption_ids = np.asarray(enc["input_ids"], np.int32)
    caption_mask = (1 - np.asarray(enc["attention_mask"])).astype(bool)  # refcoco.py:123-124

    if image.ndim == 2:  # grayscale -> RGB (refcoco.py:129-130)
        image = np.stack([image] * 3, axis=-1)

    if use_global:
        target, t_mask, context, c_mask = crop_image_to_bb(image, bbox, return_context=True)
    else:
        target, t_mask = crop_image_to_bb(image, bbox)
        context = c_mask = None

    t_img, t_m = _resize_stream(target, t_mask, image_size)
    out = dict(
        ann_id=ann_id,
        target_image=t_img,
        target_mask=t_m,
        caption_ids=caption_ids,
        caption_mask=caption_mask,
    )
    if use_global:
        c_img, c_m = _resize_stream(context, c_mask, image_size)
        out.update(context_image=c_img, context_mask=c_m)
    if use_location:
        out.update(loc_feats=compute_position_features(image.shape, bbox))
    return Sample(**out)
