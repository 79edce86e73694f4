"""MTCNN training data: imdb parsing, flips, batching, and the stage-wise
data factories (counterpart of fdt/data/mtcnn_data.py).

Anno line format (shared with the reference):
  <image path> <label> [ox1 oy1 ox2 oy2] [lx1 ly1 … lx5 ly5]
  label: 1 positive, 0 negative, -1 part, -2 landmark

The factories draw from their RandomState in fdt's order, so one seed gives
fdt's crop boxes, offsets, labels and anno lines.  Images are read by
fdt_torch.data.image_io.imread (Pillow) and patches written by
image_io.imwrite (Pillow's JPEG at quality 95) where fdt calls cv2; patches
are resized by fdt_torch.data.resize.resize (cv2's INTER_LINEAR in float,
rounded: within 1 LSB of cv2's fixed-point uint8 resize).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, List, Sequence

import numpy as np

from fdt_torch.data import image_io
from fdt_torch.data.resize import INTER_LINEAR, resize


def resize_patch(image: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(image, (size, size), interpolation=INTER_LINEAR) of a uint8
    BGR crop, within 1 LSB."""
    out = resize(image.astype(np.float32), (size, size), interpolation=INTER_LINEAR)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ imdb layer

def parse_mtcnn_imdb(anno_file: str, prefix_path: str = "") -> List[dict]:
    """Records of an anno file: image path (joined to `prefix_path` where it
    does not exist as it is, ".jpg" appended where missing), label, box
    offsets and landmarks (zeros where the line has none)."""
    imdb = []
    with open(anno_file) as f:
        for line in f:
            cells = line.strip().split(" ")
            path = cells[0].replace("\\", "/")
            if not os.path.exists(path):
                path = os.path.join(prefix_path, path)
            if not path.endswith(".jpg"):
                path += ".jpg"
            rec = {"image": path, "label": int(cells[1]), "flipped": False,
                   "bbox_target": np.zeros(4), "landmark_target": np.zeros(10)}
            rest = cells[2:]
            if len(rest) in (4, 14):
                rec["bbox_target"] = np.array(rest[:4], float)
            if len(rest) == 14:
                rec["landmark_target"] = np.array(rest[4:], float)
            imdb.append(rec)
    return imdb


def append_flipped_images(imdb: List[dict]) -> List[dict]:
    """Every record and its mirror: box x-offsets negated and swapped,
    landmark x → 1 - x with the eyes and the mouth corners swapped."""
    out = list(imdb)
    for rec in imdb:
        bbox = rec["bbox_target"].copy()
        bbox[0], bbox[2] = -bbox[2], -bbox[0]
        lm = rec["landmark_target"].copy().reshape(5, 2)
        lm = np.asarray([(1 - x, y) for (x, y) in lm])
        lm[[0, 1]] = lm[[1, 0]]
        lm[[3, 4]] = lm[[4, 3]]
        out.append({"image": rec["image"], "label": rec["label"],
                    "bbox_target": bbox, "landmark_target": lm.reshape(10),
                    "flipped": True})
    return out


def mtcnn_batches(imdb: Sequence[dict], batch_size: int, shuffle: bool = True,
                  rng: np.random.RandomState | None = None) -> Iterator:
    """One epoch of (images [B,S,S,3] uint8 BGR, labels [B], bbox [B,4],
    landmarks [B,10]), the last partial batch dropped."""
    rng = rng or np.random.RandomState(0)
    index = np.arange(len(imdb))
    if shuffle:
        rng.shuffle(index)
    for s in range(0, len(index) - batch_size + 1, batch_size):
        recs = [imdb[i] for i in index[s:s + batch_size]]
        ims, labels, bboxes, lms = [], [], [], []
        for r in recs:
            im = image_io.imread(r["image"])
            if im is None:
                raise FileNotFoundError(r["image"])
            if r["flipped"]:
                im = im[:, ::-1, :]
            ims.append(im)
            labels.append(r["label"])
            bboxes.append(r["bbox_target"])
            lms.append(r["landmark_target"])
        yield (np.asarray(ims), np.array(labels, np.float32),
               np.vstack(bboxes).astype(np.float32), np.vstack(lms).astype(np.float32))


def assemble_annotations(output_file: str, anno_file_list: Sequence[str],
                         rng: np.random.RandomState | None = None,
                         base_num: int = 250_000) -> int:
    """Merge stage anno lists into `output_file` (rewritten): from each list
    min(lines, 3·base_num) lines drawn with replacement."""
    rng = rng or np.random.RandomState(0)
    if os.path.exists(output_file):
        os.remove(output_file)
    count = 0
    for anno_file in anno_file_list:
        with open(anno_file) as f:
            lines = f.readlines()
        n = min(len(lines), base_num * 3)
        idx_keep = rng.choice(len(lines), size=n)  # with replacement, as the reference
        with open(output_file, "a+") as f:
            for i in idx_keep:
                f.write(lines[i])
                count += 1
    return count


# --------------------------------------------------------------- iou utilities

def _iou_one_to_many(box, boxes):
    """IoU of one [4+] box with [N, 4] boxes, areas with the reference's +1."""
    area = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    areas = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    xx1 = np.maximum(box[0], boxes[:, 0])
    yy1 = np.maximum(box[1], boxes[:, 1])
    xx2 = np.minimum(box[2], boxes[:, 2])
    yy2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(0, xx2 - xx1 + 1) * np.maximum(0, yy2 - yy1 + 1)
    return inter / (area + areas - inter)


# ------------------------------------------------------- stage data generators

@dataclasses.dataclass
class GenStats:
    pos: int = 0
    neg: int = 0
    part: int = 0


class _Sink:
    """The three patch directories and anno lists of one factory run."""

    def __init__(self, out_dir: str, size: int, on_patch: Callable | None):
        self.dirs = {k: os.path.join(out_dir, f"{size}/{k}")
                     for k in ("positive", "negative", "part")}
        for d in self.dirs.values():
            os.makedirs(d, exist_ok=True)
        anno_dir = os.path.join(out_dir, "anno_store")
        os.makedirs(anno_dir, exist_ok=True)
        self.files = {k: open(os.path.join(anno_dir, f"{k}_{size}.txt"), "w")
                      for k in ("pos", "neg", "part")}
        self.on_patch = on_patch
        self.stats = GenStats()

    def emit(self, kind: str, patch: np.ndarray, crop, off=None) -> None:
        n = getattr(self.stats, kind)
        folder = {"pos": "positive", "neg": "negative", "part": "part"}[kind]
        path = os.path.join(self.dirs[folder], f"{n}.jpg")
        image_io.imwrite(path, patch)
        label = {"pos": "1", "neg": "0", "part": "-1"}[kind]
        tail = "" if off is None else " %.2f %.2f %.2f %.2f" % off
        self.files[kind].write(f"{path} {label}{tail}\n")
        if self.on_patch:
            self.on_patch(kind, crop, off)
        setattr(self.stats, kind, n + 1)

    def close(self) -> GenStats:
        for f in self.files.values():
            f.close()
        return self.stats


def gen_pnet_train_data(anno_file: str, prefix: str, out_dir: str,
                        rng: np.random.RandomState | None = None,
                        neg_per_image: int = 50,
                        on_patch: Callable | None = None) -> GenStats:
    """Random-crop PNet patch factory: IoU < 0.3 negatives, ≥ 0.65
    positives, ≥ 0.4 part faces, 12² patches with offsets normalised by the
    crop size.  Writes the patches and anno_store/{pos,neg,part}_12.txt.

    on_patch(kind, crop_box [4], offsets [4] | None) observes every patch
    with its crop (kind "pos", "neg" or "part")."""
    rng = rng or np.random.RandomState(0)
    size_out = 12
    sink = _Sink(out_dir, size_out, on_patch)
    with open(anno_file) as f:
        lines = f.readlines()
    for line in lines:
        cells = line.strip().split(" ")
        img = image_io.imread(os.path.join(prefix, cells[0]))
        if img is None:
            continue
        boxes = np.array(cells[1:], dtype=np.int32).reshape(-1, 4)
        height, width, _ = img.shape

        neg_num = 0
        while neg_num < neg_per_image:
            size = rng.randint(size_out, min(width, height) // 2)
            nx, ny = rng.randint(0, width - size), rng.randint(0, height - size)
            crop = np.array([nx, ny, nx + size, ny + size])
            if np.max(_iou_one_to_many(crop, boxes)) < 0.3:
                sink.emit("neg", resize_patch(img[ny:ny + size, nx:nx + size], size_out), crop)
                neg_num += 1

        for box in boxes:
            x1, y1, x2, y2 = box
            w, h = x2 - x1 + 1, y2 - y1 + 1
            if max(w, h) < 40 or x1 < 0 or y1 < 0:
                continue
            for _ in range(5):  # negatives that overlap the face
                size = rng.randint(size_out, min(width, height) // 2)
                dx = rng.randint(max(-size, -x1), w)
                dy = rng.randint(max(-size, -y1), h)
                nx1, ny1 = max(0, x1 + dx), max(0, y1 + dy)
                if nx1 + size > width or ny1 + size > height:
                    continue
                crop = np.array([nx1, ny1, nx1 + size, ny1 + size])
                if np.max(_iou_one_to_many(crop, boxes)) < 0.3:
                    sink.emit("neg", resize_patch(img[ny1:ny1 + size, nx1:nx1 + size],
                                                  size_out), crop)
            for _ in range(20):  # positives and parts
                size = rng.randint(int(min(w, h) * 0.8), int(np.ceil(1.25 * max(w, h))))
                dx = rng.randint(int(-w * 0.2), max(int(w * 0.2), 1))
                dy = rng.randint(int(-h * 0.2), max(int(h * 0.2), 1))
                nx1 = max(x1 + w / 2 + dx - size / 2, 0)
                ny1 = max(y1 + h / 2 + dy - size / 2, 0)
                nx2, ny2 = nx1 + size, ny1 + size
                if nx2 > width or ny2 > height:
                    continue
                crop = np.array([nx1, ny1, nx2, ny2])
                iou = float(_iou_one_to_many(crop, box.reshape(1, -1))[0])
                off = ((x1 - nx1) / size, (y1 - ny1) / size,
                       (x2 - nx2) / size, (y2 - ny2) / size)
                patch = resize_patch(img[int(ny1):int(ny2), int(nx1):int(nx2)], size_out)
                if iou >= 0.65:
                    sink.emit("pos", patch, crop, off)
                elif iou >= 0.4:
                    sink.emit("part", patch, crop, off)
    return sink.close()


def gen_hard_example_data(detect_fn: Callable[[np.ndarray], np.ndarray],
                          anno_file: str, prefix: str, out_dir: str,
                          image_size: int, neg_cap_per_image: int = 60,
                          on_patch: Callable | None = None) -> GenStats:
    """Hard-example factory for RNet and ONet: the previous stage's boxes
    (detect_fn(image) → [N, 5], or None), squared and rounded, harvested as
    IoU-bucketed image_size² patches with offsets normalised by the box's
    inclusive width and height; at most `neg_cap_per_image` negatives an
    image.  Writes the patches and anno_store/{pos,neg,part}_<size>.txt."""
    from fdt_torch.infer.mtcnn import square_bbox

    sink = _Sink(out_dir, image_size, on_patch)
    with open(anno_file) as f:
        lines = f.readlines()
    for line in lines:
        cells = line.strip().split(" ")
        img = image_io.imread(os.path.join(prefix, cells[0]))
        if img is None:
            continue
        gts = np.array(list(map(float, cells[1:])), np.float32).reshape(-1, 4)
        dets = detect_fn(img)
        if dets is None or dets.shape[0] == 0:
            continue
        dets = square_bbox(dets)
        dets[:, 0:4] = np.round(dets[:, 0:4])
        neg_num = 0
        for box in dets:
            x1, y1, x2, y2 = box[:4].astype(int)
            w, h = x2 - x1 + 1, y2 - y1 + 1
            if w < 20 or x1 < 0 or y1 < 0 or x2 > img.shape[1] - 1 or y2 > img.shape[0] - 1:
                continue
            iou = _iou_one_to_many(box, gts)
            patch = resize_patch(img[y1:y2 + 1, x1:x2 + 1], image_size)
            if np.max(iou) < 0.3 and neg_num < neg_cap_per_image:
                sink.emit("neg", patch, box[:4])
                neg_num += 1
            else:
                gx1, gy1, gx2, gy2 = gts[int(np.argmax(iou))]
                off = ((gx1 - x1) / w, (gy1 - y1) / h, (gx2 - x2) / w, (gy2 - y2) / h)
                if np.max(iou) >= 0.65:
                    sink.emit("pos", patch, box[:4], off)
                elif np.max(iou) >= 0.4:
                    sink.emit("part", patch, box[:4], off)
    return sink.close()


def gen_landmark_data(anno_file: str, prefix: str, out_dir: str,
                      image_size: int = 48) -> int:
    """Landmark patch factory: each GT face cropped to an image_size² patch
    with label -2 and its 5 points normalised by the box.

    anno line: <path> <x1> <x2> <y1> <y2> <lx1> <ly1> … <lx5> <ly5>
    (the reference's CelebA-style box order).  Writes the patches and
    anno_store/landmark_<size>.txt; returns the patch count."""
    save_dir = os.path.join(out_dir, f"{image_size}/landmark")
    os.makedirs(save_dir, exist_ok=True)
    anno_dir = os.path.join(out_dir, "anno_store")
    os.makedirs(anno_dir, exist_ok=True)
    count = 0
    with open(anno_file) as f, \
            open(os.path.join(anno_dir, f"landmark_{image_size}.txt"), "w") as f_lm:
        for line in f:
            cells = line.strip().split(" ")
            img = image_io.imread(os.path.join(prefix, cells[0]))
            if img is None:
                continue
            x1, x2, y1, y2 = map(float, cells[1:5])
            lm = np.array(list(map(float, cells[5:15])), np.float32).reshape(5, 2)
            w, h = x2 - x1 + 1, y2 - y1 + 1
            if w <= 0 or h <= 0:
                continue
            crop = img[int(y1):int(y2) + 1, int(x1):int(x2) + 1]
            if crop.size == 0:
                continue
            patch = resize_patch(crop, image_size)
            norm = np.empty(10, np.float32)
            norm[0::2] = (lm[:, 0] - x1) / w
            norm[1::2] = (lm[:, 1] - y1) / h
            path = os.path.join(save_dir, f"{count}.jpg")
            image_io.imwrite(path, patch)
            f_lm.write(f"{path} -2 0 0 0 0 " + " ".join(f"{v:.4f}" for v in norm) + "\n")
            count += 1
    return count
