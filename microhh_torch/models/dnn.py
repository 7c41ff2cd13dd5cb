"""The DNN subgrid-stress closure's network (``microhh_tpu/models/dnn.py``).

The reference fork runs a TorchScript-exported E(2)-equivariant CNN through
libtorch (``src/diff_dnn_local.cxx:891-894``): a 3x3 'valid' convolution of
the 12-channel 3x3 patch, ReLU, four 1x1 convolutions and a change of basis.
Because the patch is 3x3 and the first convolution is 'valid' with a 3x3
kernel, the network is a bias-free multilayer perceptron on the flattened
12 * 3 * 3 = 108 inputs, which is how the JAX package evaluates it and how
this module does: a chain of matrix products and ReLUs, then the change of
basis P^-1 to the stress components [T11, T12, T13, T22, T23, T33].

The parameters are float32 numbers, as they are in the JAX package, whose
closure always loads them at its default float32
(``microhh_tpu/ops/diff_dnn.py:59``); they are held, exactly, in the
dtype of the run, so that a float64 run multiplies float64 activations by
float32-valued weights there and here.  Weights come from an ``.npz`` file,
a TorchScript export, numpy arrays (``from_arrays``: the JAX package's own,
in the tests), or a seeded random draw (testing; no trained nets ship).
``export_torchscript`` writes a TorchScript file in the layout of the
reference's exports (``CNDNNExport``), for the round trip through a run's
``dnnpath``.
"""

import os
import warnings

import numpy as np
import torch

# Change of basis P^-1 mapping network outputs to stress components
# [T11, T12, T13, T22, T23, T33] (analysis/util.py CNDNN.Pinv).
PINV = np.array([
    [0.5, 0., 0., 0., -0.25, 0.25],
    [0., 0., 0., 0., 0.25, 0.25],
    [0., 0., 1., 0., 0., 0.],
    [0.5, 0., 0., 0., 0.25, -0.25],
    [0., 0., 0., 1., 0., 0.],
    [0., 1., 0., 0., 0., 0.]])

N_IN = 12 * 3 * 3


class TauDNN(torch.nn.Module):
    """Weights: a list of (C_out, C_in) arrays, the first (C1, 108), the
    last (6, C); forward = ReLU-matmul chain + change of basis, no biases
    (like the reference nets).  The weights and the change of basis are
    rounded to float32 and held as buffers of ``dtype`` on ``device``."""

    def __init__(self, weights, change_basis=None, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        ws = [np.asarray(w, dtype=np.float32) for w in weights]
        if ws[0].shape[1] != N_IN:
            raise ValueError("first layer must map from %d inputs" % N_IN)
        if ws[-1].shape[0] != 6:
            raise ValueError("last layer must produce 6 outputs")
        cb = np.asarray(PINV if change_basis is None else change_basis,
                        dtype=np.float32)
        self.n_layers = len(ws)
        for i, w in enumerate(ws):
            self.register_buffer("w%d" % i, torch.tensor(
                w, dtype=dtype, device=device))
        self.register_buffer("change_basis", torch.tensor(
            cb, dtype=dtype, device=device))

    @property
    def weights(self):
        return [getattr(self, "w%d" % i) for i in range(self.n_layers)]

    def forward(self, x):
        """x: (..., 108) -> Tau (..., 6)."""
        ws = self.weights
        h = x
        for w in ws[:-1]:
            h = torch.relu(h @ w.T)
        h = h @ ws[-1].T
        return h @ self.change_basis.T

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_arrays(cls, weights, change_basis=None, dtype=torch.float32,
                    device="cpu"):
        """The network of the given (C_out, C_in) weight arrays and change
        of basis (None: P^-1), e.g. a JAX ``TauDNN``'s ``weights`` and
        ``change_basis`` as numpy arrays."""
        return cls(weights, change_basis, dtype, device)

    @classmethod
    def random(cls, hidden=(64, 64, 64, 64), seed=0, dtype=torch.float32,
               device="cpu"):
        """Seeded random weights, drawn as microhh_tpu's TauDNN.random
        draws them (one RandomState, layer by layer)."""
        rng = np.random.RandomState(seed)
        dims = [N_IN] + list(hidden) + [6]
        ws = []
        for i in range(len(dims) - 1):
            scale = np.sqrt(2. / dims[i])
            ws.append(rng.randn(dims[i + 1], dims[i]) * scale * 0.1)
        return cls(ws, dtype=dtype, device=device)

    @classmethod
    def from_npz(cls, path, dtype=torch.float32, device="cpu"):
        """Arrays ``w0``, ``w1``, ... (expanded (C_out, C_in) matrices, the
        first with the 3x3 taps: (C1, 108)) and an optional
        ``change_basis``."""
        data = np.load(path)
        ws = []
        i = 0
        while "w%d" % i in data:
            ws.append(data["w%d" % i])
            i += 1
        cb = data["change_basis"] if "change_basis" in data else None
        return cls(ws, cb, dtype, device)

    @classmethod
    def from_torchscript(cls, path, dtype=torch.float32, device="cpu"):
        """Expanded convolution filters of a TorchScript CNDNN export: the
        e2cnn export registers them as ``filter`` buffers (reference
        ``analysis/util.py``), a plain ``torch.nn`` export as 4-D
        ``Conv2d.weight`` parameters; both are (C_out, C_in, kh, kw) and
        flatten to the (C_out, C_in*kh*kw) matrix of the chain.  A (6, 6)
        tensor named ``change_basis`` replaces P^-1."""
        mod = torch.jit.load(path, map_location="cpu")
        mod.eval()
        ws = []
        cb = None
        tensors = list(mod.named_buffers()) + list(mod.named_parameters())
        filt = [(n, b) for n, b in tensors if n.endswith("filter")]
        if not filt:
            filt = [(n, b) for n, b in tensors
                    if n.endswith("weight") and b.dim() == 4]
        for _, buf in filt:
            arr = buf.detach().cpu().numpy()
            ws.append(arr.reshape(arr.shape[0], -1))
        for name, buf in tensors:
            arr = buf.detach().cpu().numpy()
            if "change_basis" in name and arr.shape == (6, 6):
                cb = arr
        if not ws:
            raise ValueError("no conv filters found in %s "
                             "(export the e2cnn model in eval() mode)" % path)
        return cls(ws, cb, dtype, device)

    @classmethod
    def load(cls, path, allow_random=False, dtype=torch.float32,
             device="cpu"):
        """Closure weights from ``path`` (.npz, else TorchScript).  A
        missing or empty path is an error unless the caller opts into
        seeded random weights (testing): random physics in a production
        run is never silent."""
        if path and os.path.exists(path):
            if path.endswith(".npz"):
                return cls.from_npz(path, dtype, device)
            return cls.from_torchscript(path, dtype, device)
        if not allow_random:
            raise ValueError(
                "[diff] dnnpath %r does not exist; swdiff=dnn_* needs trained "
                "weights (.npz or TorchScript .pt).  Set [diff] swdnnrandom=1 "
                "to run with seeded random weights (testing only)."
                % (path,))
        warnings.warn("diff_dnn: running with RANDOM closure weights "
                      "(swdnnrandom=1) - testing only")
        return cls.random(dtype=dtype, device=device)


# --------------------------------------------------------------------------
#  TorchScript exports in the reference's layout
# --------------------------------------------------------------------------

class CNDNNExport(torch.nn.Module):
    """The layout of the reference's CNDNN exports (``analysis/util.py``):
    a 3x3 'valid' convolution, ReLU, four 1x1 convolutions with ReLUs
    between them, and the change of basis, each convolution's expanded
    kernel a 'filter' buffer as e2cnn's R2Conv registers it."""

    def __init__(self, filters, change_basis):
        super().__init__()
        if len(filters) != 5:
            raise ValueError("CNDNN has 5 convolutions, not %d"
                             % len(filters))
        for i, f in enumerate(filters):
            self.register_buffer("c%d_filter" % i, torch.tensor(f))
        self.register_buffer("change_basis", torch.tensor(change_basis))

    def forward(self, x):
        # unrolled: TorchScript takes no list of buffers
        h = torch.relu(torch.nn.functional.conv2d(x, self.c0_filter))
        h = torch.relu(torch.nn.functional.conv2d(h, self.c1_filter))
        h = torch.relu(torch.nn.functional.conv2d(h, self.c2_filter))
        h = torch.relu(torch.nn.functional.conv2d(h, self.c3_filter))
        h = torch.nn.functional.conv2d(h, self.c4_filter)
        h = h.squeeze(-1).squeeze(-1)
        return h @ self.change_basis.t()


def random_filters(seed=7, hidden=(64, 64, 64, 64), scale=0.1):
    """Seeded float32 convolution filters (C_out, C_in, kh, kw) of a CNDNN,
    drawn as ``cases/run_validation.py``'s sbl_dnn leg draws them (He scale
    times ``scale``)."""
    rng = np.random.RandomState(seed)
    dims = [N_IN] + list(hidden) + [6]
    filters = []
    for i in range(len(dims) - 1):
        kh = 3 if i == 0 else 1
        cin = 12 if i == 0 else dims[i]
        filters.append((rng.randn(dims[i + 1], cin, kh, kh)
                        * np.sqrt(2. / dims[i]) * scale).astype(np.float32))
    return filters


def export_torchscript(path, filters, change_basis=None):
    """Save a CNDNNExport of the filters and change of basis (None: P^-1)
    as TorchScript at path."""
    cb = np.asarray(PINV if change_basis is None else change_basis,
                    dtype=np.float32)
    torch.jit.script(CNDNNExport(filters, cb).eval()).save(path)
