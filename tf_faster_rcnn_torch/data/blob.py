"""Image reading and blob preparation, with the pixel work on the device.

Port of ``tf_faster_rcnn_tpu/data/blob.py``. The semantics are the
reference's (lib/utils/blob.py, lib/model/test.py): BGR channel order,
PIXEL_MEANS subtracted in float32, a shortest-side scale to the target size
capped by MAX_SIZE, a bilinear resize, and the image written top-left into a
zeroed canvas whose true extent travels in im_info.

The split of the work differs. The host only decodes (``read_image_bgr``,
into uint8 arrays) and computes each image's scale and resized extent from
its shape alone (``im_scale``, ``scaled_hw``). The mean subtraction, the
resize and the canvas write are torch ops on whatever device the image
tensor lies on (``prep_im_for_blob``, ``place_on_canvas``): the card in the
engine, the CPU in the tests, the same code on both. ``upload`` moves host
arrays through pinned memory without a host sync.

The resize is cv2's INTER_LINEAR with ``fx = fy = scale`` on the float64
image the JAX package hands it: the output size is ``round(size * scale)``
(``F.interpolate`` with ``scale_factor`` floors it), destination pixel d
reads source coordinate ``(d + 0.5) / scale - 0.5``, computed in float64 and
clamped at both edges, and the two taps of each axis blend with float32
weights, the rows first. ``aten.upsample_bilinear2d`` maps by ``1 / scale``
too, but computes the coordinate in float32: on seeded uint8 noise its
pixels then drift up to 0.022 from cv2's at a 1280-pixel source, where the
taps here stay within 3e-5.

Reading needs neither cv2 nor PIL for binary PPM (``P6``), which numpy
decodes; the format is decided by the file's content, as cv2 and PIL decide
it, so a PPM under a ``.jpg`` name reads the same in both packages. Any
other format goes through cv2 (``read_image_bgr``) or PIL (``image_size``),
imported when called.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tf_faster_rcnn_torch.utils.trace import span

__all__ = ["read_image_bgr", "image_size", "im_scale", "scaled_hw",
           "upload", "prep_im_for_blob", "place_on_canvas", "prep_batch",
           "batch_image_shape", "write_ppm"]

_PPM_MAGIC = b"P6"
_HEADER_BYTES = 4096


def _ppm_header(head: bytes):
    """(width, height, maxval, raster offset) of a binary PPM header: three
    decimal fields after the magic, separated by whitespace and '#'
    comments, then one whitespace byte before the raster."""
    fields, i = [], len(_PPM_MAGIC)
    while len(fields) < 3:
        if i >= len(head):
            raise ValueError("truncated PPM header")
        c = head[i:i + 1]
        if c == b"#":
            end = head.find(b"\n", i)
            if end < 0:
                raise ValueError("truncated PPM header")
            i = end + 1
        elif c.isspace():
            i += 1
        else:
            j = i
            while j < len(head) and not head[j:j + 1].isspace() \
                    and head[j:j + 1] != b"#":
                j += 1
            fields.append(int(head[i:j]))
            i = j
    width, height, maxval = fields
    return width, height, maxval, i + 1


def _read_head(path) -> bytes:
    with open(path, "rb") as f:
        return f.read(_HEADER_BYTES)


def read_image_bgr(path) -> np.ndarray:
    """The image at path as a uint8 [H, W, 3] BGR array, as cv2.imread
    reads it. 8-bit binary PPM is decoded here; any other content goes
    through cv2."""
    head = _read_head(path)
    if head.startswith(_PPM_MAGIC):
        width, height, maxval, offset = _ppm_header(head)
        if maxval < 256:
            count = width * height * 3
            rgb = np.fromfile(path, np.uint8, count=count, offset=offset)
            if rgb.size != count:
                raise ValueError(f"truncated PPM raster in {path}")
            bgr = rgb.reshape(height, width, 3)[..., ::-1]
            return np.ascontiguousarray(bgr)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {path} needs cv2 (opencv-python): only "
                          "8-bit binary PPM is read without it") from e
    im = cv2.imread(str(path))
    if im is None:
        raise ValueError(f"failed to read image {path}")
    return im


def image_size(path) -> Tuple[int, int]:
    """(height, width) of the image at path, from its header: PPM here,
    any other format through PIL."""
    head = _read_head(path)
    if head.startswith(_PPM_MAGIC):
        width, height, _, _ = _ppm_header(head)
        return height, width
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"probing {path} needs PIL (Pillow): only binary "
                          "PPM is probed without it") from e
    with Image.open(path) as img:
        width, height = img.size
    return height, width


def write_ppm(path, im_bgr: np.ndarray):
    """Write a uint8 [H, W, 3] BGR array as an 8-bit binary PPM (whatever
    the file's extension)."""
    h, w, _ = im_bgr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(im_bgr[..., ::-1], np.uint8).tobytes())


def im_scale(h: int, w: int, target_size, max_size) -> float:
    """The scale of an h x w image: target_size over its short side, or
    max_size over its long side when the long side would round past
    max_size (the JAX package's test, in Python floats)."""
    size_min, size_max = min(h, w), max(h, w)
    scale = float(target_size) / float(size_min)
    if np.round(scale * size_max) > max_size:
        scale = float(max_size) / float(size_max)
    return scale


def scaled_hw(h: int, w: int, scale: float) -> Tuple[int, int]:
    """The extent cv2.resize gives an h x w image at fx = fy = scale."""
    return int(round(h * scale)), int(round(w * scale))


def upload(x: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on device: on a CUDA device through pinned
    memory with a non-blocking copy, so the host does not wait for the
    stream; on the CPU, the array's own memory."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    device = torch.device(device)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def prep_im_for_blob(im: torch.Tensor, pixel_means, target_size, max_size):
    """Mean-subtract and scale one image, on im's device.

    im: [H, W, 3] BGR tensor (uint8 or float); pixel_means: the three BGR
    means, a tensor on im's device or anything numpy takes. Returns (the
    float32 [h, w, 3] image, scale)."""
    h, w = int(im.shape[0]), int(im.shape[1])
    scale = im_scale(h, w, target_size, max_size)
    if not (torch.is_tensor(pixel_means) and pixel_means.device == im.device):
        pixel_means = torch.as_tensor(
            np.asarray(pixel_means, np.float32).reshape(3), device=im.device)
    x = im.to(torch.float32) - pixel_means
    oh, ow = scaled_hw(h, w, scale)
    i0, i1, a = _taps(w, ow, scale, im.device)
    a = a[None, :, None]
    rows = x[:, i0] * (1.0 - a) + x[:, i1] * a                # [h, ow, 3]
    j0, j1, b = _taps(h, oh, scale, im.device)
    b = b[:, None, None]
    return rows[j0] * (1.0 - b) + rows[j1] * b, scale


def _taps(n_in: int, n_out: int, scale: float, device):
    """cv2's INTER_LINEAR taps along one axis: for each output index, the
    two source indices and the float32 weight of the second, with the
    coordinate in float64 and clamped to [0, n_in - 1] (weight 0 there)."""
    d = torch.arange(n_out, dtype=torch.float64, device=device)
    f = (d + 0.5) * (1.0 / scale) - 0.5
    i0 = torch.floor(f)
    a = f - i0
    i0 = i0.to(torch.int64)
    edge = (i0 < 0) | (i0 >= n_in - 1)
    a = torch.where(edge, torch.zeros_like(a), a).to(torch.float32)
    i0 = i0.clamp(0, n_in - 1)
    return i0, (i0 + 1).clamp(max=n_in - 1), a


def place_on_canvas(dest: torch.Tensor, im: torch.Tensor):
    """Write a prepared [h, w, 3] image top-left into one canvas slot
    [H, W, 3]; returns (h, w), the true extent for im_info."""
    h, w = int(im.shape[0]), int(im.shape[1])
    ch, cw = int(dest.shape[0]), int(dest.shape[1])
    if h > ch or w > cw:
        raise ValueError(f"image {h}x{w} exceeds canvas {ch}x{cw}")
    dest[:h, :w] = im
    return h, w


def prep_batch(ims, canvas, device, target_sizes, max_size, pixel_means,
               flipped=None):
    """The canvases of a batch of decoded uint8 BGR images, built on
    device: (images [B, H, W, 3] float32, im_info [B, 3], orig_hw [B, 2]),
    all on device. Image i is flipped left-right when flipped[i] (on the
    device, after the upload), then prepared at target_sizes[i] capped by
    max_size. pixel_means: the three BGR means, a tensor on device. Scales
    and extents come from the shapes, on the host."""
    with span("data.prep"):
        b = len(ims)
        images = torch.zeros((b, int(canvas[0]), int(canvas[1]), 3),
                             dtype=torch.float32, device=device)
        im_info = np.zeros((b, 3), np.float32)
        orig_hw = np.zeros((b, 2), np.float32)
        for i, im in enumerate(ims):
            orig_hw[i] = (im.shape[0], im.shape[1])
            x = upload(im, device)
            if flipped is not None and flipped[i]:
                x = torch.flip(x, dims=[1])
            prepped, scale = prep_im_for_blob(x, pixel_means,
                                              target_sizes[i], max_size)
            h, w = place_on_canvas(images[i], prepped)
            im_info[i] = (h, w, scale)
        return images, upload(im_info, device), upload(orig_hw, device)


def batch_image_shape(b: int, canvas_hw: Tuple[int, int]):
    """Shape of a batch of canvases, [b, H, W, 3]. The JAX package's
    space-to-depth layout (TPU.SPACE_TO_DEPTH) is a TPU stem workaround that
    the port does not run."""
    from tf_faster_rcnn_torch.config import cfg
    if cfg.TPU.SPACE_TO_DEPTH:
        raise NotImplementedError(
            "TPU.SPACE_TO_DEPTH is a TPU stem workaround; the port runs the "
            "plain 7x7 stem (ROADMAP.md, Rules of the port)")
    ch, cw = canvas_hw
    return (b, int(ch), int(cw), 3)
