"""Minimal ONNX executor (pure numpy) for host-side sidecar models (a copy
of masr_tpu/infer/onnx_runtime.py, which the port may not import).

The reference runs its silero-VAD model through onnxruntime
(masr/infer_utils/vad_predictor.py:36-104); neither onnx nor onnxruntime
is needed, since ONNX files are plain protobuf — this
module parses the wire format directly (hand-rolled varint reader, no
protobuf dependency) and interprets the graph in numpy.

Scope: the op subset used by silero VAD v3 (Conv1d incl. grouped /
depthwise, ONNX-semantics LSTM with iofc gate order, If subgraphs with
outer-scope name resolution, Pad/Slice/Gather/Reduce and elementwise
math). All ops carry ONNX opset-13+ semantics for the forms that actually
appear in such exports; unsupported forms raise rather than mis-compute.

VAD is a host-side sidecar (decides segment boundaries for predict_long);
it stays numpy/CPU by design — the GPU runs the ASR model, not the VAD.
"""
import numpy as np

INT64_MAX = 2 ** 63 - 1

# ONNX TensorProto.DataType → numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


# --------------------------------------------------------------------- #
# protobuf wire-format reader
# --------------------------------------------------------------------- #
def _read_varint(buf, i):
    r = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << s
        if not b & 0x80:
            return r, i
        s += 7


def _signed(v):
    """Two's-complement interpretation of a 64-bit varint."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf):
    """→ list of (field_number, wire_type, raw_value)."""
    i = 0
    out = []
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.append((fn, wt, v))
    return out


def _get(fs, n):
    return [v for f, _, v in fs if f == n]


def _varints(raw):
    """Decode a packed repeated-varint payload."""
    out = []
    i = 0
    while i < len(raw):
        v, i = _read_varint(raw, i)
        out.append(_signed(v))
    return out


def _parse_tensor(buf):
    """TensorProto → ndarray."""
    fs = _fields(buf)
    dims = []
    for f, w, v in fs:
        if f == 1:
            if w == 0:
                dims.append(_signed(v))
            else:  # packed
                dims.extend(_varints(v))
    dt = _get(fs, 2)
    dtype = _DTYPES[dt[0]] if dt else np.float32
    raw = _get(fs, 9)
    if raw:
        arr = np.frombuffer(raw[0], dtype=dtype)
    else:
        # packed typed fields: float_data=4 (fixed32), int32_data=5,
        # int64_data=7, double_data=10
        if dtype == np.float32 and _get(fs, 4):
            payload = b"".join(v if isinstance(v, bytes) else b""
                               for f, w, v in fs if f == 4)
            arr = np.frombuffer(payload, dtype=np.float32) if payload else \
                np.asarray([np.frombuffer(v, np.float32)[0]
                            for f, w, v in fs if f == 4 and w == 5],
                           np.float32)
        elif dtype in (np.int64,) and _get(fs, 7):
            vals = []
            for f, w, v in fs:
                if f == 7:
                    vals.extend(_varints(v) if w == 2 else [_signed(v)])
            arr = np.asarray(vals, np.int64)
        elif _get(fs, 5):
            vals = []
            for f, w, v in fs:
                if f == 5:
                    vals.extend(_varints(v) if w == 2 else [_signed(v)])
            arr = np.asarray(vals, np.int32).astype(dtype)
        else:
            arr = np.zeros(0, dtype)
    name = _get(fs, 8)
    return (name[0].decode() if name else ""), arr.reshape(dims)


class _Attr(object):
    __slots__ = ("name", "f", "i", "s", "t", "g", "floats", "ints")

    def __init__(self, buf):
        fs = _fields(buf)
        self.name = _get(fs, 1)[0].decode()
        self.f = None
        self.i = None
        self.s = None
        self.t = None
        self.g = None
        self.floats = []
        self.ints = []
        for f, w, v in fs:
            if f == 2:
                self.f = np.frombuffer(v, np.float32)[0]
            elif f == 3:
                self.i = _signed(v)
            elif f == 4:
                self.s = v
            elif f == 5:
                self.t = _parse_tensor(v)[1]
            elif f == 6:
                self.g = _Graph(v)
            elif f == 7:
                self.floats.extend(
                    np.frombuffer(v, np.float32).tolist() if w == 2
                    else [np.frombuffer(v, np.float32)[0]])
            elif f == 8:
                self.ints.extend(_varints(v) if w == 2 else [_signed(v)])


class _Node(object):
    __slots__ = ("op", "inputs", "outputs", "attrs")

    def __init__(self, buf):
        fs = _fields(buf)
        self.inputs = [v.decode() for f, _, v in fs if f == 1]
        self.outputs = [v.decode() for f, _, v in fs if f == 2]
        self.op = _get(fs, 4)[0].decode()
        self.attrs = {}
        for ab in _get(fs, 5):
            a = _Attr(ab)
            self.attrs[a.name] = a


class _Graph(object):
    __slots__ = ("nodes", "inits", "inputs", "outputs")

    def __init__(self, buf):
        fs = _fields(buf)
        self.nodes = [_Node(nb) for nb in _get(fs, 1)]
        self.inits = {}
        for tb in _get(fs, 5):
            name, arr = _parse_tensor(tb)
            self.inits[name] = arr
        self.inputs = [_io_name(vb) for vb in _get(fs, 11)]
        self.outputs = [_io_name(vb) for vb in _get(fs, 12)]


def _io_name(buf):
    return _get(_fields(buf), 1)[0].decode()


# --------------------------------------------------------------------- #
# numpy op kernels
# --------------------------------------------------------------------- #
def _conv(x, w, b, attrs):
    """Grouped 1-D convolution, NCL layout (the only form silero uses)."""
    if x.ndim != 3 or w.ndim != 3:
        raise NotImplementedError(f"Conv rank {x.ndim} unsupported")
    strides = attrs.get("strides")
    stride = strides.ints[0] if strides and strides.ints else 1
    pads = attrs.get("pads")
    pb, pe = (pads.ints[0], pads.ints[1]) if pads and pads.ints else (0, 0)
    dil = attrs.get("dilations")
    if dil and dil.ints and dil.ints[0] != 1:
        raise NotImplementedError("dilated Conv unsupported")
    groups = attrs.get("group")
    g = groups.i if groups and groups.i else 1
    if pb or pe:
        x = np.pad(x, ((0, 0), (0, 0), (pb, pe)))
    B, Cin, L = x.shape
    Cout, Cin_g, K = w.shape
    T = (L - K) // stride + 1
    # specialized fast forms (BLAS matmul / shifted adds) for the shapes
    # that dominate batched VAD runs; grouped-general keeps the einsum
    if K == 1 and g == 1:
        xs = x[:, :, ::stride] if stride > 1 else x
        out = (xs.transpose(0, 2, 1).reshape(B * T, Cin) @ w[:, :, 0].T) \
            .reshape(B, T, Cout).transpose(0, 2, 1)
    elif g == Cin and Cout == Cin and Cin_g == 1:
        out = np.zeros((B, Cout, T), np.float32)
        for k in range(K):
            out += w[:, 0, k][None, :, None] \
                * x[:, :, k: k + (T - 1) * stride + 1: stride]
    elif g == 1:
        win = np.lib.stride_tricks.sliding_window_view(
            x, K, axis=2)[:, :, ::stride]       # (B, Cin, T, K)
        col = win.transpose(0, 2, 1, 3).reshape(B * T, Cin * K)
        out = (col @ w.reshape(Cout, Cin * K).T) \
            .reshape(B, T, Cout).transpose(0, 2, 1)
    else:
        win = np.lib.stride_tricks.sliding_window_view(
            x, K, axis=2)[:, :, ::stride]
        win = win.reshape(B, g, Cin // g, T, K)
        wg = w.reshape(g, Cout // g, Cin_g, K)
        out = np.einsum("bgctk,gock->bgot", win, wg,
                        optimize=True).reshape(B, Cout, T)
    if b is not None:
        out = out + b[None, :, None]
    return np.ascontiguousarray(out, np.float32)


def _lstm(X, W, R, B, init_h, init_c, hidden_size):
    """ONNX LSTM, forward, layout=0: X (T,B,I); gate order i,o,f,c."""
    W, R = W[0], R[0]
    H = hidden_size
    if B is not None:
        Wb, Rb = B[0, : 4 * H], B[0, 4 * H:]
        bias = Wb + Rb
    else:
        bias = 0.0
    T, Bn, _ = X.shape
    h = init_h[0] if init_h is not None else np.zeros((Bn, H), np.float32)
    c = init_c[0] if init_c is not None else np.zeros((Bn, H), np.float32)
    ys = np.empty((T, Bn, H), np.float32)
    Wt, Rt = W.T, R.T
    for t in range(T):
        gates = X[t] @ Wt + h @ Rt + bias
        i = _sigmoid(gates[:, 0 * H:1 * H])
        o = _sigmoid(gates[:, 1 * H:2 * H])
        f = _sigmoid(gates[:, 2 * H:3 * H])
        cg = np.tanh(gates[:, 3 * H:4 * H])
        c = f * c + i * cg
        h = o * np.tanh(c)
        ys[t] = h
    return ys[:, None], h[None], c[None]  # Y (T,1,B,H), Y_h, Y_c


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _slice_op(data, starts, ends, axes, steps):
    starts = np.atleast_1d(starts).tolist()
    ends = np.atleast_1d(ends).tolist()
    axes = np.atleast_1d(axes).tolist() if axes is not None \
        else list(range(len(starts)))
    steps = np.atleast_1d(steps).tolist() if steps is not None \
        else [1] * len(starts)
    sl = [slice(None)] * data.ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = int(a) % data.ndim
        e = int(e)
        if e >= INT64_MAX // 2:
            e = None
        elif e <= -INT64_MAX // 2:
            e = None if int(st) < 0 else 0
        sl[a] = slice(int(s), e, int(st))
    return data[tuple(sl)]


def _pad_op(data, pads, mode, cval):
    pads = np.asarray(pads).reshape(2, -1)
    widths = list(zip(pads[0].tolist(), pads[1].tolist()))
    if mode == b"reflect":
        return np.pad(data, widths, mode="reflect")
    if mode == b"edge":
        return np.pad(data, widths, mode="edge")
    return np.pad(data, widths, mode="constant",
                  constant_values=cval if cval is not None else 0)


# --------------------------------------------------------------------- #
# interpreter
# --------------------------------------------------------------------- #
class OnnxModel(object):
    """Parse + run an ONNX file. `run(feeds)` → {output_name: ndarray}."""

    def __init__(self, path):
        with open(path, "rb") as f:
            data = f.read()
        top = _fields(data)
        graphs = _get(top, 7)
        if not graphs:
            raise ValueError(f"not an ONNX model: {path}")
        self.graph = _Graph(graphs[0])
        self.input_names = [n for n in self.graph.inputs
                            if n not in self.graph.inits]
        self.output_names = list(self.graph.outputs)

    def run(self, feeds):
        env = dict(self.graph.inits)
        env.update(feeds)
        self._run_graph(self.graph, env)
        return {n: env[n] for n in self.graph.outputs}

    # ------------------------------------------------------------------ #
    def _run_graph(self, graph, env):
        for name, arr in graph.inits.items():
            env.setdefault(name, arr)
        for node in graph.nodes:
            self._run_node(node, env)

    def _run_node(self, node, env):
        def inp(i, default=None):
            if i >= len(node.inputs) or node.inputs[i] == "":
                return default
            return env[node.inputs[i]]

        op = node.op
        a = node.attrs
        if op == "Conv":
            out = _conv(inp(0), inp(1), inp(2), a)
        elif op == "LSTM":
            direction = a.get("direction")
            if direction and direction.s not in (b"forward", b"", None):
                raise NotImplementedError("only forward LSTM supported")
            Y, Yh, Yc = _lstm(inp(0), inp(1), inp(2), inp(3),
                              inp(5), inp(6), a["hidden_size"].i)
            outs = [Y, Yh, Yc]
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
            return
        elif op == "If":
            cond = bool(np.asarray(inp(0)).reshape(()))
            branch = a["then_branch"].g if cond else a["else_branch"].g
            sub_env = dict(env)  # outer-scope reads allowed (ONNX scoping)
            self._run_graph(branch, sub_env)
            for name, sub_name in zip(node.outputs, branch.outputs):
                env[name] = sub_env[sub_name]
            return
        elif op == "Shape":
            start = a["start"].i if "start" in a and a["start"].i else 0
            out = np.asarray(inp(0).shape[start:], np.int64)
        elif op == "Gather":
            axis = a["axis"].i if "axis" in a and a["axis"].i else 0
            out = np.take(inp(0), inp(1), axis=axis)
        elif op == "Unsqueeze":
            axes = inp(1)
            out = inp(0)
            for ax in sorted(np.atleast_1d(axes).tolist()):
                out = np.expand_dims(out, int(ax))
        elif op == "Squeeze":
            axes = inp(1)
            if axes is None:
                out = np.squeeze(inp(0))
            else:
                out = inp(0)
                for ax in sorted(np.atleast_1d(axes).tolist(), reverse=True):
                    out = np.squeeze(out, int(ax))
        elif op == "Concat":
            xs = [inp(i) for i in range(len(node.inputs))]
            out = np.concatenate(xs, axis=a["axis"].i or 0)
        elif op == "Reshape":
            shape = np.atleast_1d(inp(1)).astype(np.int64).copy()
            x = inp(0)
            allowzero = a.get("allowzero")
            if not (allowzero and allowzero.i):
                for i, s in enumerate(shape):
                    if s == 0:
                        shape[i] = x.shape[i]
            out = x.reshape(shape.tolist())
        elif op == "Pad":
            mode = a["mode"].s if "mode" in a else b"constant"
            out = _pad_op(inp(0), inp(1), mode, inp(2))
        elif op == "Slice":
            out = _slice_op(inp(0), inp(1), inp(2), inp(3), inp(4))
        elif op == "Pow":
            out = np.power(inp(0), inp(1))
        elif op == "Add":
            out = inp(0) + inp(1)
        elif op == "Mul":
            out = inp(0) * inp(1)
        elif op == "Neg":
            out = -inp(0)
        elif op == "Sqrt":
            out = np.sqrt(inp(0))
        elif op == "Log":
            out = np.log(inp(0))
        elif op == "Relu":
            out = np.maximum(inp(0), 0)
        elif op == "Sigmoid":
            out = _sigmoid(inp(0))
        elif op == "Equal":
            out = np.equal(inp(0), inp(1))
        elif op == "Cast":
            out = np.asarray(inp(0)).astype(_DTYPES[a["to"].i])
        elif op == "Transpose":
            perm = a["perm"].ints if "perm" in a else None
            out = np.transpose(inp(0), perm)
        elif op == "ReduceMean":
            axes = tuple(a["axes"].ints) if "axes" in a and a["axes"].ints \
                else None
            keep = bool(a["keepdims"].i) if "keepdims" in a and \
                a["keepdims"].i is not None else True
            out = np.mean(inp(0), axis=axes, keepdims=keep,
                          dtype=np.float32 if inp(0).dtype == np.float32
                          else None)
        elif op == "ConstantOfShape":
            shape = np.atleast_1d(inp(0)).astype(np.int64).tolist()
            value = a["value"].t if "value" in a else np.zeros(1, np.float32)
            out = np.full(shape, value.reshape(-1)[0], value.dtype)
        elif op == "Identity":
            out = inp(0)
        else:
            raise NotImplementedError(f"ONNX op not supported: {op}")
        env[node.outputs[0]] = out
