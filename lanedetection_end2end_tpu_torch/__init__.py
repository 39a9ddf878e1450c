"""PyTorch + CUDA port of lanedetection_end2end_tpu (serving path).

See README.md, section "PyTorch port".
"""
