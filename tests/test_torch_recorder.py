"""The reference's Recorder tests against the port (the twin of
tests/test_recorder.py), run on the CPU."""

from tests.test_torch_operator_grids import twin

twin("test_recorder", globals())
