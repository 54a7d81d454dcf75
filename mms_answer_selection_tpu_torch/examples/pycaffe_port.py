"""A canonical pycaffe training script, running unmodified (twin of
``examples/pycaffe_port.py``).

This mirrors the flow every caffe Python tutorial teaches (build a net
with net_spec, write the prototxt, get_solver, step while reading blobs,
save/restore — the examples/01-learning-lenet.ipynb shape): the only
change a ported script needs is the import line.

    python -m mms_answer_selection_tpu_torch.examples.pycaffe_port [DIR]

The script writes HDF5 data and HDF5 snapshots, so it needs h5py, which
the H100 host lacks: it runs on hosts with h5py (on the CPU after
``caffe.set_mode_cpu()``; ``set_mode_gpu()`` chooses the card).  The MLP
launches none of the port's kernels.

Reference surface being exercised: python/caffe/__init__.py exports,
net_spec.py, pycaffe.py, _caffe.cpp Solver bindings.
"""

import os
import sys
import tempfile

import numpy as np

from mms_answer_selection_tpu_torch import caffe_compat as caffe


def make_data(workdir, n=512, seed=0):
    """A separable 3-class problem written as reference-style HDF5."""
    import h5py

    rng = np.random.default_rng(seed)
    w = rng.normal(size=(8, 3))
    xs = rng.normal(size=(n, 8)).astype(np.float32)
    ys = np.argmax(xs @ w, axis=1).astype(np.float64)
    path = os.path.join(workdir, "train.h5")
    with h5py.File(path, "w") as f:
        f["data"], f["label"] = xs, ys
    listfile = os.path.join(workdir, "train.txt")
    with open(listfile, "w") as f:
        f.write(path + "\n")
    return listfile


def make_net(listfile):
    n = caffe.NetSpec()
    n.data, n.label = caffe.layers.HDF5Data(
        batch_size=64, source=listfile, shuffle=True, ntop=2)
    n.ip1 = caffe.layers.InnerProduct(
        n.data, num_output=32, weight_filler={"type": "xavier"})
    n.relu1 = caffe.layers.ReLU(n.ip1, in_place=True)
    n.ip2 = caffe.layers.InnerProduct(
        n.ip1, num_output=3, weight_filler={"type": "xavier"})
    n.loss = caffe.layers.SoftmaxWithLoss(n.ip2, n.label)
    n.acc = caffe.layers.Accuracy(n.ip2, n.label)
    return str(n.to_proto())  # the pycaffe write-to-file idiom


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    workdir = argv[0] if argv else os.path.join(tempfile.gettempdir(),
                                                "pycaffe_port")
    os.makedirs(workdir, exist_ok=True)
    listfile = make_data(workdir)

    with open(os.path.join(workdir, "net.prototxt"), "w") as f:
        f.write(make_net(listfile))
    with open(os.path.join(workdir, "solver.prototxt"), "w") as f:
        f.write(f"""net: "{workdir}/net.prototxt"
base_lr: 0.1
lr_policy: "inv"
gamma: 0.0001
power: 0.75
momentum: 0.9
max_iter: 500
display: 100
snapshot_prefix: "{workdir}/lenet"
snapshot_format: HDF5
random_seed: 7
""")

    caffe.set_mode_gpu()  # the card
    solver = caffe.get_solver(os.path.join(workdir, "solver.prototxt"))

    log = []
    for _ in range(5):
        solver.step(100)
        log.append((solver.iter, float(solver.net.blobs['loss'].data),
                    float(solver.net.blobs['acc'].data)))
        print(f"iter {solver.iter}: "
              f"loss={log[-1][1]:.4f} "
              f"acc={log[-1][2]:.3f}")

    model_path, state_path = solver.snapshot()
    print(f"snapshotted {model_path}")

    # the restore round-trip
    solver2 = caffe.get_solver(os.path.join(workdir, "solver.prototxt"))
    solver2.restore(state_path)
    assert solver2.iter == solver.iter
    w1 = np.asarray(solver.net.params["ip1"]["w"])
    np.testing.assert_array_equal(
        w1, np.asarray(solver2.net.params["ip1"]["w"]))

    # deploy-style inference through caffe.Net
    net = caffe.Net(os.path.join(workdir, "net.prototxt"), caffe.TEST,
                    weights=model_path)
    out = net.forward()
    acc = float(out["acc"])
    print(f"deploy forward: acc={acc:.3f}")
    assert acc > 0.9
    print("OK")
    return {"log": log, "snapshot": model_path, "deploy_acc": acc}


if __name__ == "__main__":
    main()
