"""The controls read apart from the program at a size a test run holds
(a small model on the CPU, three seeds), as the cells' limits ask at
their own sizes (PERF.md gives those readings): serving's plain
reference in float8 products, and the program's own int8 path in
training (AdamW's int8 gradient compression), each reads more than
three times the program's largest reading."""
from portbench import run as R
from portbench.control import int8_path, serve_control
from portbench.tests.conftest import small_serve, small_train

SEEDS = (1, 2, 3)


def test_serving_control_reads_apart(manifest):
    conf, traffic, limits = small_serve(manifest)
    prog, ctrl = [], []
    for seed in SEEDS:
        out = R.run_cell(conf, traffic, limits, seed=seed, seconds=5.0,
                         trace=False, device="cpu")
        prog.append(out["compared"]["max_logit_gap"])
        ctrl.append(serve_control(conf, seed, "cpu", out["check"]))
    assert min(ctrl) > 3 * max(prog), (prog, ctrl)


def test_training_control_reads_apart(manifest):
    conf, traffic, limits = small_train(manifest)
    prog, ctrl = [], []
    for seed in SEEDS:
        for side, (c, t) in ((prog, (conf, traffic)),
                             (ctrl, int8_path(conf, traffic))):
            out = R.run_cell(c, t, limits, seed=seed, seconds=0.3,
                             trace=False, device="cpu")
            side.append(out["compared"]["change_gap"])
    assert min(ctrl) > 3 * max(prog), (prog, ctrl)
