"""Models found by name (``reference/registry.py``): every count and every
seeded weight the harness read before the lookup existed, held exactly; a
model that enters as one new module; and a name no module declares, refused.

The literals were taken from the harness as it stood before its models moved
into their own modules (``flops.py`` and ``reference/train.py`` branching on
the two names), at each cell's (configuration, batch, (fineSize, fineSize),
bytes an element) and at the tiny configurations' (batch 4, fp32)."""

import hashlib

import pytest
import torch

from port_bench import common, flops, run
from port_bench.reference import registry
from port_bench.reference import train as rtrain
from port_bench.tests import tiny

# {case: (configuration, batch, side, bytes an element)}
CASES = {
    "m2i-train-bf16-b32": ("pix2pixhd-global-512", 32, 512, 2),
    "b2m-train-bf16-b128": ("box2mask-twostream-128", 128, 128, 2),
    "m2i-serve-fp32-b1": ("pix2pixhd-global-512", 1, 512, 4),
    "m2i-train-fp32-b16": ("pix2pixhd-global-512", 16, 512, 4),
    "tiny-m2i": ("pix2pixHD", 4, 64, 4),
    "tiny-b2m": ("box2mask", 4, 32, 4),
}

# {case: (train_step, g_forward, port_differences)}
PARENT_COUNTS = {
    "m2i-train-bf16-b32": (
        {"conv_fwd": 31844921901056.0, "conv_wgrad": 18419175129088.0,
         "conv_dgrad": 23116090572800.0, "linear": 0.0, "in_fwd_bytes": 13845725184,
         "in_bwd_bytes": 19859193856, "conv": 73380187602944.0},
        15804182036480.0, 390180372480.0),
    "b2m-train-bf16-b128": (
        {"conv_fwd": 3872952418304.0, "conv_wgrad": 3544282824704.0,
         "conv_dgrad": 3202286878720.0, "linear": 9175040.0, "in_fwd_bytes": 4215799808,
         "in_bwd_bytes": 6117687296, "conv": 10619522121728.0},
        2886943637504.0, 79744204800.0),
    "m2i-serve-fp32-b1": (
        {"conv_fwd": 995153809408.0, "conv_wgrad": 575599222784.0,
         "conv_dgrad": 722377830400.0, "linear": 0.0, "in_fwd_bytes": 865143808,
         "in_bwd_bytes": 1240985600, "conv": 2293130862592.0},
        493880688640.0, 12193136640.0),
    "m2i-train-fp32-b16": (
        {"conv_fwd": 15922460950528.0, "conv_wgrad": 9209587564544.0,
         "conv_dgrad": 11558045286400.0, "linear": 0.0, "in_fwd_bytes": 13842300928,
         "in_bwd_bytes": 19855769600, "conv": 36690093801472.0},
        7902091018240.0, 195090186240.0),
    "tiny-m2i": (
        {"conv_fwd": 24555428864.0, "conv_wgrad": 796115968.0, "conv_dgrad": 12059380736.0,
         "linear": 0.0, "in_fwd_bytes": 5947904, "in_bwd_bytes": 8718336,
         "conv": 37410925568.0},
        614405120.0, 101597184.0),
    "tiny-b2m": (
        {"conv_fwd": 349522944.0, "conv_wgrad": 320135168.0, "conv_dgrad": 181240832.0,
         "linear": 35840.0, "in_fwd_bytes": 1973504, "in_bwd_bytes": 2926592,
         "conv": 850898944.0},
        261359616.0, 21307392.0),
}

# SHA-256 of every tensor of ``make_weights`` (net, name, shape, dtype and
# bytes, in draw order) on the CPU at seed 2**31 + 11, and the elements.
PARENT_WEIGHTS = {
    ("pix2pixhd-global-512", True):
        ("2f691872d5a632ea80086cb3963cf83ce79281f48c5f2096b7642b203e9bcebf", 208183749),
    ("pix2pixhd-global-512", False):
        ("393aff767a030af12a34666f342aff9920e670e9cf2124376fc4802bd30411d3", 182556163),
    ("box2mask-twostream-128", True):
        ("de51e0fe1185dc8c1b54186bcb5f3e14055ac030a56e2e2a7c0e4e8646b89135", 26883877),
    ("box2mask-twostream-128", False):
        ("7113fcca54beb55e8c81104c1e3e60b3734a06d2065e4fbb3f9dae1808f6bdd8", 24049508),
}


def _config(name):
    if name in tiny._CONFIGS:
        return tiny.config(name)
    return common.load_json(common.named_file("configs", name))


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_equal_the_parents_exactly(case):
    name, n, side, elem = CASES[case]
    cfg, hw = _config(name), (side, side)
    got = (flops.train_step(cfg, n, hw, elem), flops.g_forward(cfg, n, hw),
           flops.port_differences(cfg, n, hw))
    assert got == PARENT_COUNTS[case]


@pytest.mark.parametrize("name,train", sorted(PARENT_WEIGHTS))
def test_seeded_weights_equal_the_parents_bit_for_bit(name, train):
    w = common.make_weights(_config(name), 2**31 + 11, torch.device("cpu"), train=train)
    h, count = hashlib.sha256(), 0
    for net, sd in w.items():
        for k, t in sd.items():
            h.update(f"{net}.{k}:{tuple(t.shape)}:{t.dtype};".encode())
            h.update(t.contiguous().numpy().tobytes())
            count += t.numel()
    assert (h.hexdigest(), count) == PARENT_WEIGHTS[(name, train)]


def test_each_model_is_declared_by_one_module():
    found = registry.declarations()
    assert {"pix2pixHD", "box2mask"} <= set(found)
    assert all(len(paths) == 1 for paths in found.values())
    for model in found:
        assert registry.find(model).MODEL == model


def test_an_unknown_model_is_refused_by_name_and_never_counted_as_another():
    cfg = dict(tiny.config("box2mask"), model="no-such-model")
    calls = [lambda: flops.train_step(cfg, 4, (32, 32), 4),
             lambda: flops.g_forward(cfg, 1, (32, 32)),
             lambda: flops.port_differences(cfg, 4, (32, 32)),
             lambda: common.make_weights(cfg, 1, torch.device("cpu")),
             lambda: rtrain.build(cfg, True, torch.device("cpu"), {})]
    for call in calls:
        with pytest.raises(registry.UnknownModel, match=r"'no-such-model'.*port_bench/reference"):
            call()
    with pytest.raises(KeyError, match="no-such-model"):
        tiny.config("no-such-model")


def test_a_cell_of_an_unknown_model_fails_with_the_registrys_error():
    bench, files = tiny.bench_and_files()
    files["configs"]["tiny-b2m"] = dict(files["configs"]["tiny-b2m"], model="no-such-model")
    argv = ["--workload", "b2m", "--seed", "1", "--seconds", "0.1"]
    with pytest.raises(registry.UnknownModel, match="no-such-model"):
        run.execute(argv, bench=bench, require_cuda=False, device=torch.device("cpu"),
                    files=files)


def test_a_name_declared_twice_is_refused(tmp_path):
    (tmp_path / "again.py").write_text('MODEL = "pix2pixHD"\n')
    with pytest.raises(registry.UnknownModel, match="declared by 2 modules"):
        registry.find("pix2pixHD", (str(tmp_path),))


def test_a_test_only_model_is_found_only_in_its_directory():
    with pytest.raises(registry.UnknownModel):
        registry.find("pix2pixHD-twin")
    twin = registry.find("pix2pixHD-twin", tiny.MODEL_DIRS)
    assert twin.MODEL == "pix2pixHD-twin" and twin.__name__ == "port_bench.tests.models.twin"


@pytest.mark.parametrize("twin,same", [("twin", "m2i"), ("twin-srv", "srv")])
def test_a_model_enters_as_one_module(twin, same):
    """The third model runs a train cell and a serving cell through the
    harness as pix2pixHD does: the same readings and the same counts."""
    res, got = tiny.execute(twin)
    ref_res, ref = tiny.execute(same)
    assert got.model.MODEL == "pix2pixHD-twin" and ref.model.MODEL == "pix2pixHD"
    assert res["correct"] and ref_res["correct"], (res["check"], ref_res["check"])
    assert got.readings == ref.readings
    assert got.layer["work"] == ref.layer["work"]
    assert set(res["metrics"]) == set(ref_res["metrics"])
