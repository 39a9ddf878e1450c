"""Label-file handling for the TuSimple-format datasets.

The port's copy of `lanedetection_end2end_tpu/data/labels.py`. The
reference reads three kinds of newline-delimited JSON label files
(SURVEY.md §0; Birds_Eye_View_Loss/Dataloader/Load_Data_new.py:45-46,
Backprojection_Loss/Dataloader/Load_Data_new.py:88-90):

- ``Curve_parameters.json``  — per image ``{"poly_params": 4x[a,b,c]}``: BEV
  2nd-degree coefficients per lane, three zeros = lane absent (README.md:40).
- ``lanes_ordered.json``     — per image ``{"lanes": 4xN x-coordinates,
  "h_samples": N row heights}`` ordered [left-left, left, right, right-right].
- ``label_new.json``         — per image ``{"lines": 10 ints}`` line-type
  annotations in 10 slots (5 left | 5 right); slots 3:7 are the 4 tracked
  lanes (Load_Data_new.py:109 / :187).
- ``label_data_*.json``      — raw TuSimple gt ``{"lanes", "h_samples",
  "raw_file"}`` used by the LaneEval benchmark.

All functions are host-side numpy/stdlib — label IO never touches the device.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Sequence


def read_json_lines(path: str) -> List[dict]:
    """Newline-delimited JSON reader (the format of every reference label file)."""
    with open(path, "r") as f:
        return [json.loads(line) for line in f if line.strip()]


def write_json_lines(path: str, records: Iterable[dict]) -> None:
    with open(path, "w") as f:
        for rec in records:
            json.dump(rec, f)
            f.write("\n")


def mirror_list(lst: Sequence) -> list:
    """Mirror the 10-slot line-type annotation for horizontal flips.

    Reverses each half and swaps the halves (left lanes <-> right lanes),
    matching `mirror_list` (Birds_Eye_View_Loss/Dataloader/Load_Data_new.py:120-127).
    """
    middle = len(lst) // 2
    first = list(reversed(lst[:middle]))
    second = list(reversed(lst[middle:]))
    return second + first


def image_indices(image_dir: str) -> List[int]:
    """0-based label indices of the sorted image files.

    The reference maps file ``NNNN.png`` -> label line ``NNNN-1``
    (Load_Data_new.py:53-54 / :97-98).
    """
    content = sorted(os.listdir(image_dir))
    return [int(name.split(".")[0]) - 1 for name in content]


def load_valid_set_file_all(valid_idx: Sequence[int], target_file: str,
                            image_dir: str, labels_file: str) -> None:
    """Extract the gt label lines of the validation images into `target_file`.

    Parity with `load_valid_set_file_all`
    (Birds_Eye_View_Loss/Dataloader/Load_Data_new.py:448-458,
    Backprojection_Loss/Dataloader/Load_Data_new.py:323-334), with the label
    source passed explicitly instead of hard-coded.
    """
    labels = read_json_lines(labels_file)
    target_idx = image_indices(image_dir)
    new_idx = [target_idx[i] for i in valid_idx]
    write_json_lines(target_file, (labels[i] for i in new_idx))
