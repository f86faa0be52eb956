"""CellNet — the reference's tiny dense MLP runtime, on jax.

Reference: ml/CellNet.java (feedForwardDense :763), ml/CellNetParser.java
(.bbnet text format: header `#dims a b c...`, then `C<id> TYPE bias w...`
per cell, dense concise layout), ml/Functions.java activations:
  SIG 1/(1+e^-x) (:23), TANH (:126), RSLOG sign(x)*log(|x|+1) (:241),
  MSIG mirrored sigmoid (offset 5, xmult 2, ymult 1/sig(5), :292-323),
  SWISH x*sig(x) (:170), ESIG 2*sig(x)-1 (:61), EMSIG 2*mSig(x)-1,
  BELL e^(-x^2), LINEAR.
These nets back BBMerge's ML filter, NovaDemux, CallVariants scoring and
the prok gene caller (SURVEY.md §2 "NN runtime").

Batched: a layer is one [out, in] matmul over the whole batch; mixed
per-cell activations inside a layer are computed as a select over the
(few) activation types present. Training is jax.grad over the same
forward (the reference hand-rolls backprop in ml/Trainer.java).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np

TYPES = ["SIG", "TANH", "RSLOG", "MSIG", "SWISH", "ESIG", "EMSIG", "BELL",
         "LINEAR"]
_MSIG_OFF = 5.0
_MSIG_XMULT = 2.0
_MSIG_YMULT = None  # computed lazily: 1/sigmoid(5)


def _activations(x, types):
    """Apply per-cell activations; x [..., n], types int array [n]."""
    import jax.numpy as jnp

    global _MSIG_YMULT
    if _MSIG_YMULT is None:
        _MSIG_YMULT = float(1.0 / (1.0 / (1.0 + np.exp(-_MSIG_OFF))))
    sig = 1.0 / (1.0 + jnp.exp(-x))
    msig = jnp.where(
        x < 0,
        1.0 / (1.0 + jnp.exp(-(_MSIG_XMULT * x + _MSIG_OFF))),
        1.0 / (1.0 + jnp.exp(_MSIG_XMULT * x - _MSIG_OFF)),
    ) * _MSIG_YMULT
    outs = [
        sig,
        jnp.tanh(x),
        jnp.sign(x) * jnp.log(jnp.abs(x) + 1.0),
        msig,
        x * sig,
        2.0 * sig - 1.0,
        2.0 * msig - 1.0,
        jnp.exp(-(x * x)),
        x,
    ]
    t = jnp.asarray(types)
    result = outs[0]
    for i in range(1, len(outs)):
        result = jnp.where(t == i, outs[i], result)
    return result


@dataclass
class CellNet:
    dims: list
    weights: list  # per layer: [out, in] float32
    biases: list  # per layer: [out]
    types: list  # per layer: int array [out]
    cutoff: float = 0.5
    header: dict = field(default_factory=dict)

    def forward(self, x):
        """x [B, dims[0]] -> output [B, dims[-1]] (jax)."""
        import jax
        import jax.numpy as jnp

        h = jnp.asarray(x, jnp.float32)
        for W, b, t in zip(self.weights, self.biases, self.types):
            # full float32: a GPU would otherwise take TF32 and could flip
            # nn= decisions in bbmerge and callvariants
            z = jnp.matmul(
                h, jnp.asarray(W).T, precision=jax.lax.Precision.HIGHEST
            ) + jnp.asarray(b)
            h = _activations(z, t)
        return h

    def apply(self, x) -> np.ndarray:
        import jax

        return np.asarray(jax.jit(self.forward)(np.atleast_2d(x)))

    def classify(self, x) -> np.ndarray:
        return self.apply(x)[:, 0] >= self.cutoff

    # ---- training (capability parity with ml/Trainer.java) ----
    def fit(self, x, y, epochs=2000, lr=0.05, seed=0):
        """Minimal full-batch Adam on sigmoid-output MSE (the reference
        trains with hand-rolled SGD + momentum; jax.grad replaces it)."""
        import jax
        import jax.numpy as jnp

        params = {
            "w": [jnp.asarray(w) for w in self.weights],
            "b": [jnp.asarray(b) for b in self.biases],
        }
        types = self.types
        x = jnp.asarray(x, jnp.float32)
        y = jnp.asarray(y, jnp.float32)

        def fwd(p, xin):
            h = xin
            for W, b, t in zip(p["w"], p["b"], types):
                z = jnp.matmul(h, W.T, precision=jax.lax.Precision.HIGHEST)
                h = _activations(z + b, t)
            return h

        def loss(p):
            out = fwd(p, x)
            return jnp.mean((out - y) ** 2)

        import optax

        opt = optax.adam(lr)
        state = opt.init(params)

        @jax.jit
        def step(p, s):
            l, g = jax.value_and_grad(loss)(p)
            up, s = opt.update(g, s)
            return optax.apply_updates(p, up), s, l

        for _ in range(epochs):
            params, state, l = step(params, state)
        self.weights = [np.asarray(w) for w in params["w"]]
        self.biases = [np.asarray(b) for b in params["b"]]
        return float(l)

    @classmethod
    def create(cls, dims, seed=0, hidden="SIG", out="SIG"):
        rng = np.random.default_rng(seed)
        ws, bs, ts = [], [], []
        for i in range(1, len(dims)):
            fan = dims[i - 1]
            ws.append(
                rng.normal(0, 1.0 / np.sqrt(fan), (dims[i], fan)).astype(
                    np.float32
                )
            )
            bs.append(np.zeros(dims[i], np.float32))
            name = out if i == len(dims) - 1 else hidden
            ts.append(np.full(dims[i], TYPES.index(name), np.int32))
        return cls(list(dims), ws, bs, ts)


def _open(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def _a48_to_float(tok: str) -> float:
    """ByteBuilder.appendFloatA48 inverse: big-endian 6-bit symbols
    (chr+48) of the float's raw 32-bit pattern."""
    v = 0
    for ch in tok:
        v = (v << 6) | (ord(ch) - 48)
    return float(
        np.uint32(v & 0xFFFFFFFF).view(np.float32)
    )


def parse_bbnet(path: str) -> CellNet:
    """Parse a dense concise .bbnet file (CellNetParser.java layout),
    decimal or `#coding A48` float coding."""
    dims = None
    header = {}
    cutoff = 0.5
    cells = {}
    a48 = False
    with _open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("##ctf") or line.startswith("#ctf"):
                cutoff = float(line.split()[-1])
            elif line.startswith("##"):
                key = line[2:].split(None, 1)
                if key:
                    header[key[0]] = key[1] if len(key) > 1 else ""
                continue
            elif line.startswith("#"):
                parts = line.split(None, 1)
                key = parts[0][1:]
                header[key] = parts[1] if len(parts) > 1 else ""
                if key == "dims":
                    dims = [int(v) for v in parts[1].split()]
                elif key == "coding":
                    a48 = parts[1].strip().upper() == "A48"
            elif line[0] in "CW":
                f = line.split()
                cid = int(f[0][1:])
                typ = TYPES.index(f[1].upper())
                if a48:
                    vals = np.array(
                        [_a48_to_float(v) for v in f[2:]], np.float32
                    )
                else:
                    vals = np.array([float(v) for v in f[2:]], np.float32)
                cells[cid] = (typ, vals[0], vals[1:])
    if dims is None:
        raise ValueError(f"{path}: no #dims header")
    weights, biases, types = [], [], []
    cid = dims[0] + 1  # cell ids start at 1 (CellNet.java:311 reserves 0)
    for li in range(1, len(dims)):
        n_out, n_in = dims[li], dims[li - 1]
        W = np.zeros((n_out, n_in), np.float32)
        b = np.zeros(n_out, np.float32)
        t = np.zeros(n_out, np.int32)
        for j in range(n_out):
            typ, bias, w = cells[cid]
            if len(w) != n_in:
                raise ValueError(
                    f"cell C{cid}: {len(w)} weights, expected {n_in}"
                )
            W[j] = w
            b[j] = bias
            t[j] = typ
            cid += 1
        weights.append(W)
        biases.append(b)
        types.append(t)
    return CellNet(dims, weights, biases, types, cutoff, header)


def save_bbnet(net: CellNet, path: str) -> None:
    lines = ["##bbnet", "#version 1", "#concise", "#dense",
             f"#layers {len(net.dims)}",
             "#dims " + " ".join(str(d) for d in net.dims),
             f"##ctf {net.cutoff:.6f}",
             "#edges %d" % sum(w.size for w in net.weights)]
    cid = net.dims[0] + 1
    for W, b, t in zip(net.weights, net.biases, net.types):
        lines.append(f"##layer")
        for j in range(W.shape[0]):
            ws = " ".join(f"{v:.6f}" for v in W[j])
            lines.append(f"C{cid} {TYPES[int(t[j])]} {b[j]:.6f} {ws}")
            cid += 1
    data = "\n".join(lines) + "\n"
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as fh:
            fh.write(data)
    else:
        with open(path, "w") as fh:
            fh.write(data)
