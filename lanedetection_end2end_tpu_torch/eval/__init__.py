"""TuSimple evaluation: LaneEval, the backprojection of fitted curves and
the test-set driver."""
