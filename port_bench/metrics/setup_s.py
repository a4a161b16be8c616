"""Process start to the first timed frame or step: imports, CUDA context,
kernel load or build, inputs, warm-up (and the first checked fit steps)."""
UNIT = "s"
LAYER = "end to end"


def read(result, root):
    return result["setup_s"]
