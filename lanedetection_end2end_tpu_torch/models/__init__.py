"""The port's modules: ERFNet, heads, LaneNet, the serving engine."""
