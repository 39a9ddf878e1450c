"""The input pipeline: label files, the synthetic dataset, the datasets,
the loaders and the prefetch onto the card."""

from lanedetection_end2end_tpu_torch.data.labels import (  # noqa: F401
    load_valid_set_file_all, mirror_list, read_json_lines, write_json_lines)
from lanedetection_end2end_tpu_torch.data.dataset import (  # noqa: F401
    LaneDataset, LaneTestSet)
from lanedetection_end2end_tpu_torch.data.loader import (  # noqa: F401
    DevicePrefetcher, Loader, get_loader, get_testloader, split_indices)
from lanedetection_end2end_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticLanes, make_synthetic_root)
