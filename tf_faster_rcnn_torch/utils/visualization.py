"""Ground-truth and detection box rendering for summaries and demos.

A copy of ``tf_faster_rcnn_tpu/utils/visualization.py``, with PIL imported
when a drawing function is called, not at import. Functional parity with the
reference's PIL renderer (lib/utils/visualization.py:17-89): per-class
colors from the same fixed 121-name palette in the same order (class i keeps
its color across both packages), labeled rectangles, a batch of one image
in, an image out. The training loop's GT image summary uses it, and the
demo (tools/demo.py) draws its detections with ``draw_detections``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["STANDARD_COLORS", "NUM_COLORS", "draw_bounding_boxes",
           "draw_detections"]

# the reference's palette, order-preserved (visualization.py:17-47)
STANDARD_COLORS = """
AliceBlue Chartreuse Aqua Aquamarine Azure Beige Bisque BlanchedAlmond
BlueViolet BurlyWood CadetBlue AntiqueWhite Chocolate Coral CornflowerBlue
Cornsilk Crimson Cyan DarkCyan DarkGoldenRod DarkGrey DarkKhaki DarkOrange
DarkOrchid DarkSalmon DarkSeaGreen DarkTurquoise DarkViolet DeepPink
DeepSkyBlue DodgerBlue FireBrick FloralWhite ForestGreen Fuchsia Gainsboro
GhostWhite Gold GoldenRod Salmon Tan HoneyDew HotPink IndianRed Ivory Khaki
Lavender LavenderBlush LawnGreen LemonChiffon LightBlue LightCoral LightCyan
LightGoldenRodYellow LightGray LightGrey LightGreen LightPink LightSalmon
LightSeaGreen LightSkyBlue LightSlateGray LightSlateGrey LightSteelBlue
LightYellow Lime LimeGreen Linen Magenta MediumAquaMarine MediumOrchid
MediumPurple MediumSeaGreen MediumSlateBlue MediumSpringGreen
MediumTurquoise MediumVioletRed MintCream MistyRose Moccasin NavajoWhite
OldLace Olive OliveDrab Orange OrangeRed Orchid PaleGoldenRod PaleGreen
PaleTurquoise PaleVioletRed PapayaWhip PeachPuff Peru Pink Plum PowderBlue
Purple Red RosyBrown RoyalBlue SaddleBrown Green SandyBrown SeaGreen
SeaShell Sienna Silver SkyBlue SlateBlue SlateGray SlateGrey Snow
SpringGreen SteelBlue GreenYellow Teal Thistle Tomato Turquoise Violet
Wheat White WhiteSmoke Yellow YellowGreen
""".split()

NUM_COLORS = len(STANDARD_COLORS)


def _class_color(cls_index: int) -> str:
    return STANDARD_COLORS[cls_index % NUM_COLORS]


def _labeled_rect(canvas, box, label: str, color: str,
                  thickness: int = 4) -> None:
    """Outline `box` and stamp `label` on a filled tag at its top-left, on
    a PIL ImageDraw canvas."""
    from PIL import ImageFont
    x1, y1, x2, y2 = box
    canvas.line([(x1, y1), (x1, y2), (x2, y2), (x2, y1), (x1, y1)],
                width=thickness, fill=color)
    try:
        font = ImageFont.load_default()
    except Exception:
        return
    l, t, r, b = canvas.textbbox((0, 0), label, font=font)
    tw, th = r - l, b - t
    pad = np.ceil(0.05 * th)
    canvas.rectangle([(x1, y1), (x1 + tw + 2 * pad, y1 + th + 2 * pad)],
                     fill=color)
    canvas.text((x1 + pad, y1 + pad), label, fill='black', font=font)


def draw_bounding_boxes(image, gt_boxes, im_info=None):
    """image: [1, H, W, 3] or [H, W, 3] float (RGB, 0-255); gt_boxes:
    [N, 5] (x1, y1, x2, y2, cls) in scaled coords; im_info: (h, w, scale).
    Returns the annotated image with the same leading shape."""
    from PIL import Image, ImageDraw
    batched = image.ndim == 4
    img = image[0] if batched else image
    inv = 1.0 / float(im_info[2]) if im_info is not None else 1.0
    pil = Image.fromarray(np.uint8(np.clip(img, 0, 255)))
    canvas = ImageDraw.Draw(pil)
    for i, row in enumerate(np.asarray(gt_boxes)):
        cls = int(row[4])
        _labeled_rect(canvas, [float(v) * inv for v in row[:4]],
                      'N%02d-C%02d' % (i, cls), _class_color(cls))
    out = np.asarray(pil).astype(np.float32)
    return out[None] if batched else out


def draw_detections(image, dets, class_names):
    """image: [H, W, 3] uint8 RGB; dets: rows (cls, score, x1, y1, x2, y2)
    in image coordinates. Returns a PIL image with each row's box outlined
    in its class's color and labeled 'name score'."""
    from PIL import Image, ImageDraw
    pil = Image.fromarray(np.ascontiguousarray(image, np.uint8))
    canvas = ImageDraw.Draw(pil)
    for cls, score, x1, y1, x2, y2 in dets:
        cls = int(cls)
        _labeled_rect(canvas, [float(x1), float(y1), float(x2), float(y2)],
                      '{:s} {:.3f}'.format(class_names[cls], float(score)),
                      _class_color(cls))
    return pil
