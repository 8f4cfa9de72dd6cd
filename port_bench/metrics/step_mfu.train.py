"""step_mfu.train: the train step's model FLOPs (``flops.train_step``:
convolutions and linear layers, forward and the backward the step needs)
over the window's seconds a step, as a share of the tier's peak (bf16: 989
TFLOP/s; full fp32, TF32 off: 67), in %. Moves ``train_samples_per_s``."""


def read(r):
    if r.get("kind") != "train":
        return None
    work = r["work"]["conv"] + r["work"]["linear"]
    return 100.0 * work / r["step_s"] / r["peaks"]["flops_per_s"][r["tier"]]
