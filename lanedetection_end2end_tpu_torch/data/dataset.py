"""Host-side datasets producing fixed-shape numpy samples.

Counterpart of `lanedetection_end2end_tpu/data/dataset.py`: `LaneDataset`
(both label profiles; the port trains the 'bp' one) and `LaneTestSet`, the
same samples for the same index and flip. Every sample is a dict of
fixed-shape numpy arrays (lanes padded to 4x56), images NHWC. Images are
decoded with PIL, the bottom 640 rows cropped and resized to (resize,
2*resize) by the native library (`data/native.py`, PIL's triangle filter
in C++; a failed build raises, there is no second resampler). With
`image_dtype="uint8"` the image ships unflipped with a per-sample `flip`
flag and `train/steps.py::prepare_batch` mirrors and normalizes it on the
device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from lanedetection_end2end_tpu_torch.data.labels import mirror_list, read_json_lines

NUM_POINTS = 56  # TuSimple h_samples rows 160..710 step 10
NUM_LANES = 4


def _decode_and_resize(img_path: str, gt_path: Optional[str], resize: int):
    """Crop the bottom 640 rows, resize to (resize, 2*resize): the image
    by the triangle filter into [0, 1] float32, the gt mask by nearest
    neighbour (uint8)."""
    from lanedetection_end2end_tpu_torch.data import native

    with open(img_path, "rb") as f:
        image = Image.open(f).convert("RGB")
    w, h = image.size
    arr = np.asarray(image, dtype=np.uint8)[h - 640:]
    img_out = native.resample_to_f32(arr, resize, 2 * resize)
    if gt_path is None:
        return img_out, None
    with open(gt_path, "rb") as f:
        gt = Image.open(f).convert("P")
    gt_arr = np.asarray(gt, dtype=np.uint8)[h - 640:]
    return img_out, native.resize_nearest_u8(gt_arr, resize, 2 * resize)


class LaneDataset:
    """Labeled dataset, serving both profiles.

    Args:
      profile: 'bev' (poly-param labels) or 'bp' (ordered-lane labels).
      image_dir/gt_dir: directories of NNNN.png images / P-mode gt masks.
      curves_file: Curve_parameters.json (BEV; `poly_params`).
      lanes_file: lanes_ordered.json (BP; `lanes` + `h_samples`).
      line_file: label_new.json (`lines` 10-slot type annotations).
      valid_idx: DATASET indices of validation images (flip never applied).
      resize: output height; width is 2*resize.
      nclasses: 2 or 4 (classes 3/4 zeroed from gt when < 3 —
        Load_Data_new.py:163-165; the BEV tree always zeroes, :82-85).
      expected_size: dataset-size assertion (3626 BP / 2535 BEV; None skips —
        needed because our synthetic fixtures are smaller).
    """

    def __init__(self, profile: str, image_dir: str, gt_dir: str,
                 valid_idx: Sequence[int], resize: int = 256,
                 nclasses: int = 2, flip_on: bool = False,
                 curves_file: Optional[str] = None,
                 lanes_file: Optional[str] = None,
                 line_file: Optional[str] = None,
                 expected_size: Optional[int] = None,
                 cache_images: bool = True,
                 image_dtype: str = "float32"):
        if profile not in ("bev", "bp"):
            raise ValueError(f"unknown profile {profile!r}")
        if image_dtype not in ("float32", "uint8"):
            raise ValueError(f"unknown image_dtype {image_dtype!r}")
        # 'uint8' ships quarter-size image/gt tensors to the device;
        # train/steps.prepare_batch normalizes there.
        self.image_dtype = image_dtype
        self.profile = profile
        self.image_dir = image_dir
        self.gt_dir = gt_dir
        self.resize = resize
        self.nclasses = nclasses
        self.flip_on = flip_on
        self.rgb_lst = sorted(os.listdir(image_dir))
        self.gt_lst = sorted(os.listdir(gt_dir))
        if len(self.rgb_lst) != len(self.gt_lst):
            raise ValueError("image/gt directory size mismatch")
        if expected_size is not None and len(self.rgb_lst) != expected_size:
            raise ValueError(
                f"expected {expected_size} images, found {len(self.rgb_lst)}")

        self.params = read_json_lines(curves_file) if curves_file else None
        self.ordered_lanes = read_json_lines(lanes_file) if lanes_file else None
        self.line_file = read_json_lines(line_file) if line_file else None
        if profile == "bev" and self.params is None:
            raise ValueError("the 'bev' profile requires curves_file")
        if profile == "bp" and self.ordered_lanes is None:
            raise ValueError("the 'bp' profile requires lanes_file")

        # File NNNN.png -> label line NNNN-1 (Load_Data_new.py:53-54, :97-98).
        target_idx = [int(n.split(".")[0]) for n in self.rgb_lst]
        self.valid_idx = [target_idx[i] - 1 for i in valid_idx]

        # Single-pass uint8 lookup tables for the gt class remaps. They fold
        # the class-3/4 drop (Load_Data_new.py:163-165 BP / :82-85 BEV) and
        # the under-mirror class swaps 1<->2, 3<->4 (:96-99 / :160-168) into
        # one fancy-index over the mask — the np.isin boolean passes they
        # replace were the second-hottest stage of a warm fetch.
        lut = np.arange(256, dtype=np.uint8)
        if profile == "bev" or nclasses < 3:
            lut[3] = lut[4] = 0
        flip_lut = lut.copy()
        flip_lut[1], flip_lut[2] = lut[2], lut[1]
        flip_lut[3], flip_lut[4] = lut[4], lut[3]
        self._gt_lut = lut
        self._gt_flip_lut = flip_lut
        self._gt_lut_is_identity = bool(np.all(lut == np.arange(256)))

        # In-RAM cache of the decoded+resized uint8 image and gt mask.
        # TuSimple at 256x512 is ~1.5 GB as u8 — steady-state epochs then
        # skip PNG/JPEG decode and resampling entirely (the dominant host
        # cost) and only pay the u8->f32 normalize (native.u8_to_unit_f32).
        # All accesses (including the caching one) serve from the u8
        # quantization so values are identical across epochs.
        self._cache: Optional[Dict[int, tuple]] = {} if cache_images else None

    def __len__(self) -> int:
        return len(self.rgb_lst)

    # ------------------------------------------------------------------
    def _decoded(self, idx: int):
        """-> (img_u8 (H, W, 3), gt_u8 (H, W)), from the RAM cache or from
        PNG decode + resample. Both arrays may be cache-owned: callers must
        treat them as read-only (the label paths only ever produce
        remapped copies via the LUTs)."""
        if self._cache is not None:
            hit = self._cache.get(idx)
            if hit is not None:
                return hit
        img_path = os.path.join(self.image_dir, self.rgb_lst[idx])
        gt_path = os.path.join(self.gt_dir, self.gt_lst[idx])
        image, gt_u8 = _decode_and_resize(img_path, gt_path, self.resize)
        img_u8 = np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if self._cache is not None:
            self._cache[idx] = (img_u8, gt_u8)
        return img_u8, gt_u8

    def _remap_gt(self, gt_u8: np.ndarray, do_flip: bool) -> np.ndarray:
        """Mirror + class remap in ONE uint8 fancy-index pass (replaces the
        reference's isin masks + in-place writes, Load_Data_new.py:160-168).
        Never mutates `gt_u8` (it may be cache-owned)."""
        if do_flip:
            return self._gt_flip_lut[gt_u8[:, ::-1]]
        if self._gt_lut_is_identity:
            return gt_u8
        return self._gt_lut[gt_u8]

    def __getitem__(self, idx: int, *, flip: bool = False) -> Dict[str, np.ndarray]:
        assert self.rgb_lst[idx].split(".")[0] == self.gt_lst[idx].split(".")[0]
        img_u8, gt = self._decoded(idx)
        label_idx = int(self.rgb_lst[idx].split(".")[0]) - 1
        is_valid = label_idx in self.valid_idx
        do_flip = flip and self.flip_on and not is_valid

        if self.line_file is not None:
            line_lst = list(self.line_file[label_idx]["lines"])
        else:
            line_lst = [0] * 10

        gt = self._remap_gt(gt, do_flip)
        if self.profile == "bev":
            sample = self._bev_labels(label_idx, gt, line_lst, do_flip)
        else:
            sample = self._bp_labels(label_idx, gt, line_lst, do_flip)

        if self.image_dtype == "uint8":
            # Compact-transfer mode: the image ships UNFLIPPED uint8 with a
            # per-sample `flip` flag; train/steps.prepare_batch mirrors it on
            # the device, so the host never pays the strided uint8 mirror
            # copy. gt stays uint8 too (prepare_batch widens it on the
            # device).
            sample["image"] = img_u8
            sample["flip"] = np.bool_(do_flip)
        else:
            sample["gt"] = sample["gt"].astype(np.int32)
            from lanedetection_end2end_tpu_torch.data import native
            sample["image"] = native.u8_to_unit_f32(img_u8, flip=do_flip)
        sample["idx"] = np.int32(label_idx)
        sample["is_valid"] = np.bool_(is_valid)
        return sample

    # -- BEV tree labels (Load_Data_new.py:73-117) ----------------------
    # `gt` arrives uint8, already mirrored + class-remapped by _remap_gt
    # (the 3/4 drop at :82-85 and the 1<->2 swap at :96-99 live in the LUT).
    def _bev_labels(self, label_idx, gt, line_lst, do_flip):
        params = np.array(self.params[label_idx]["poly_params"],
                          dtype=np.float64)  # (4, 3)
        if do_flip:
            line_lst = mirror_list(line_lst)
            # Mirror BEV coefficients: x -> 1-x means p -> -p, c -> 1+c;
            # lane order swaps pairwise (:96-99).
            params = params[[1, 0, 3, 2]]
            params = -params
            params[:, -1] = 1 + params[:, -1]
        # Horizon gt: first nonzero gt row (:106-108).
        nz = np.flatnonzero(gt.any(axis=1))
        y_val = int(nz[0]) if nz.size else 0
        horizon = np.zeros(self.resize, dtype=np.float32)
        horizon[:y_val] = 1.0
        line = np.array(line_lst[3:7], dtype=np.int64) + 1  # 3-way {0,1,2}
        return {
            "gt": gt,
            "params": params.astype(np.float32),
            "line": line.astype(np.int32),
            "horizon": horizon,
        }

    # -- BP tree labels (Load_Data_new.py:110-197) ----------------------
    # `gt` arrives uint8, already mirrored + class-remapped by _remap_gt
    # (the nclasses<3 drop at :163-165 and the 1<->2 / 3<->4 swaps at
    # :160-168 live in the LUT).
    def _bp_labels(self, label_idx, gt, line_lst, do_flip):
        rec = self.ordered_lanes[label_idx]
        lanes = np.array(rec["lanes"], dtype=np.float64)  # (4, <=56)
        h_samples = np.array(rec["h_samples"], dtype=np.float64)
        # Left-pad to 56 columns with -2 (:135-137).
        pad = NUM_POINTS - lanes.shape[1]
        lanes = np.hstack([np.full((NUM_LANES, pad), -2.0), lanes])
        h_samples = np.concatenate(
            [160.0 + 10.0 * np.arange(pad), h_samples]) if pad else h_samples

        valid_points = (lanes > 0).astype(np.int32)
        valid_points[:, :8] = 0  # start from h_samples = 210 (:140-141)

        # Resize coordinates into the cropped (resize, 2*resize) frame (:143-147).
        lanes = lanes / 2.5
        track = lanes < 0
        h_res = h_samples / 2.5 - 32.0
        lanes[track] = -2.0

        if do_flip:
            lanes = (2 * self.resize - 1) - lanes
            lanes[track] = -2.0
            lanes = lanes[[1, 0, 3, 2]]
            valid_points = valid_points[[1, 0, 3, 2]]
            line_lst = mirror_list(line_lst)

        # Horizon: min valid resized y over lanes, default resize (:149-155).
        horizon_lanes = []
        for k in range(NUM_LANES):
            ys = [y for x, y in zip(lanes[k], h_res) if x != -2]
            horizon_lanes.append(min(ys) if ys else float(self.resize))
        y_val = min(horizon_lanes)
        horizon = np.zeros(self.resize, dtype=np.float32)
        horizon[: int(np.floor(y_val))] = 1.0

        # Line presence gt in {0,1} (:187-188).
        line = np.clip(np.array(line_lst[3:7], dtype=np.float64) + 1, 0, 1)
        return {
            "gt": gt,
            "lanes": lanes.astype(np.float32),
            "valid_points": valid_points.astype(np.float32),
            "line": line.astype(np.float32),
            "horizon": horizon,
        }


class LaneTestSet:
    """Image-only TuSimple test set (Backprojection_Loss/Load_Data_new.py:43-66)."""

    def __init__(self, gt_file: str, path: str, resize: int = 256,
                 cache_images: bool = True):
        self.img_info: List[dict] = read_json_lines(gt_file)
        self.path = path
        self.resize = resize
        self._cache: Optional[Dict[int, np.ndarray]] = (
            {} if cache_images else None)

    def __len__(self) -> int:
        return len(self.img_info)

    def __getitem__(self, idx: int, *, flip: bool = False) -> Dict[str, np.ndarray]:
        del flip  # test images are never augmented
        from lanedetection_end2end_tpu_torch.data import native
        img_u8 = self._cache.get(idx) if self._cache is not None else None
        if img_u8 is None:
            img_name = os.path.join(self.path,
                                    self.img_info[idx]["raw_file"])
            image, _ = _decode_and_resize(img_name, None, self.resize)
            img_u8 = np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)
            if self._cache is not None:
                self._cache[idx] = img_u8
        return {"image": native.u8_to_unit_f32(img_u8), "idx": np.int32(idx)}
