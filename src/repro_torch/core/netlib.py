"""Paper workloads as Cocco computation graphs (paper §5.1.1).

plain:        VGG16 [57]
multi-branch: ResNet50 / ResNet152 [20], GoogleNet [59], Transformer [64], GPT [52]
irregular:    RandWire-A/B [68] (seeded Watts-Strogatz generators, networkx),
              NasNet-A [75]

Modelling conventions (paper §5.1.1): FC layers are 1x1 convolutions; pooling
and element-wise layers are depth-wise convolutions without weights; scalar
ops (activations) are hidden in the PE pipeline.  Activations and weights are
INT8 (1 byte/element).  The sliding axis is the feature-map height (rows);
``line_bytes = W_out * C_out``.  'same' padding: H_out = ceil(H/s).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from .graph import FULL, Graph


class NetBuilder:
    """Tracks (H, W, C) through the net and emits graph nodes."""

    def __init__(self, name: str, h: int, w: int, c: int) -> None:
        self.g = Graph(name)
        # virtual input: a source node with the input tensor, no weights
        self.input = self.g.add_node("input", h, w * c)
        self.shapes: Dict[int, Tuple[int, int, int]] = {self.input: (h, w, c)}

    def shape(self, node: int) -> Tuple[int, int, int]:
        return self.shapes[node]

    def conv(self, src: int, cout: int, f: int = 1, s: int = 1,
             name: str = "conv", depthwise: bool = False,
             weightless: bool = False) -> int:
        h, w, c = self.shapes[src]
        ho, wo = math.ceil(h / s), math.ceil(w / s)
        if depthwise:
            cout = c
            wbytes = 0 if weightless else f * f * c
            macs = ho * wo * c * f * f
        else:
            wbytes = 0 if weightless else f * f * c * cout
            macs = ho * wo * cout * f * f * c
        idx = self.g.add_node(name, ho, wo * cout, wbytes, macs)
        self.g.add_edge(src, idx, F=min(f, h), s=s)
        self.shapes[idx] = (ho, wo, cout)
        return idx

    def pool(self, src: int, f: int, s: int, name: str = "pool") -> int:
        return self.conv(src, 0, f, s, name=name, depthwise=True,
                         weightless=True)

    def global_pool(self, src: int, name: str = "gap") -> int:
        h, w, c = self.shapes[src]
        idx = self.g.add_node(name, 1, c, 0, h * w * c)
        self.g.add_edge(src, idx, F=h, s=h)
        self.shapes[idx] = (1, 1, c)
        return idx

    def fc(self, src: int, cout: int, name: str = "fc") -> int:
        """FC over a (possibly spatial) input: flattens the window."""
        h, w, c = self.shapes[src]
        wbytes = h * w * c * cout
        macs = wbytes
        idx = self.g.add_node(name, 1, cout, wbytes, macs)
        self.g.add_edge(src, idx, F=h, s=max(h, 1))
        self.shapes[idx] = (1, 1, cout)
        return idx

    def eltwise(self, srcs: Sequence[int], name: str = "add") -> int:
        h, w, c = self.shapes[srcs[0]]
        idx = self.g.add_node(name, h, w * c, 0, h * w * c * len(srcs))
        for s in srcs:
            self.g.add_edge(s, idx, F=1, s=1)
        self.shapes[idx] = (h, w, c)
        return idx

    def concat(self, srcs: Sequence[int], name: str = "concat") -> int:
        h, w, _ = self.shapes[srcs[0]]
        ctot = sum(self.shapes[s][2] for s in srcs)
        idx = self.g.add_node(name, h, w * ctot, 0, 0)
        for s in srcs:
            self.g.add_edge(s, idx, F=1, s=1)
        self.shapes[idx] = (h, w, ctot)
        return idx

    def attention(self, src: int, name: str = "attn") -> int:
        """Sequence-global op: full dependency on the producer."""
        h, w, c = self.shapes[src]
        idx = self.g.add_node(name, h, w * c, 0, 0)
        self.g.add_edge(src, idx, kind=FULL)
        self.shapes[idx] = (h, w, c)
        return idx

    def mark_output(self, node: int) -> None:
        self.g.nodes[node].is_output = True

    def done(self, out: Optional[int] = None) -> Graph:
        if out is not None:
            self.mark_output(out)
        else:
            for v in self.g.sinks():
                self.g.nodes[v].is_output = True
        return self.g


# ---------------------------------------------------------------------------
# plain: VGG16
# ---------------------------------------------------------------------------

def vgg16() -> Graph:
    b = NetBuilder("vgg16", 224, 224, 3)
    x = b.input
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    i = 0
    for v in cfg:
        if v == "M":
            x = b.pool(x, 2, 2, name=f"pool{i}")
        else:
            x = b.conv(x, v, 3, 1, name=f"conv{i}")
            i += 1
    x = b.fc(x, 4096, "fc6")
    x = b.fc(x, 4096, "fc7")
    x = b.fc(x, 1000, "fc8")
    return b.done(x)


# ---------------------------------------------------------------------------
# multi-branch: ResNet-50 / ResNet-152
# ---------------------------------------------------------------------------

def _bottleneck(b: NetBuilder, x: int, cmid: int, stride: int,
                tag: str, project: bool) -> int:
    cout = cmid * 4
    y = b.conv(x, cmid, 1, 1, name=f"{tag}.c1")
    y = b.conv(y, cmid, 3, stride, name=f"{tag}.c2")
    y = b.conv(y, cout, 1, 1, name=f"{tag}.c3")
    if project:
        sc = b.conv(x, cout, 1, stride, name=f"{tag}.proj")
    else:
        sc = x
    return b.eltwise([y, sc], name=f"{tag}.add")


def _resnet(name: str, blocks: Sequence[int]) -> Graph:
    b = NetBuilder(name, 224, 224, 3)
    x = b.conv(b.input, 64, 7, 2, name="conv1")
    x = b.pool(x, 3, 2, name="pool1")
    cmid = 64
    for li, n in enumerate(blocks):
        for bi in range(n):
            stride = 2 if (li > 0 and bi == 0) else 1
            project = bi == 0
            x = _bottleneck(b, x, cmid, stride, f"l{li+1}b{bi}", project)
        cmid *= 2
    x = b.global_pool(x)
    x = b.fc(x, 1000, "fc")
    return b.done(x)


def resnet50() -> Graph:
    return _resnet("resnet50", [3, 4, 6, 3])


def resnet152() -> Graph:
    return _resnet("resnet152", [3, 8, 36, 3])


# ---------------------------------------------------------------------------
# multi-branch: GoogleNet
# ---------------------------------------------------------------------------

def _inception(b: NetBuilder, x: int, c1: int, c3r: int, c3: int,
               c5r: int, c5: int, cp: int, tag: str) -> int:
    br1 = b.conv(x, c1, 1, 1, name=f"{tag}.1x1")
    br2 = b.conv(x, c3r, 1, 1, name=f"{tag}.3x3r")
    br2 = b.conv(br2, c3, 3, 1, name=f"{tag}.3x3")
    br3 = b.conv(x, c5r, 1, 1, name=f"{tag}.5x5r")
    br3 = b.conv(br3, c5, 5, 1, name=f"{tag}.5x5")
    br4 = b.pool(x, 3, 1, name=f"{tag}.pool")
    br4 = b.conv(br4, cp, 1, 1, name=f"{tag}.poolp")
    return b.concat([br1, br2, br3, br4], name=f"{tag}.cat")


def googlenet() -> Graph:
    b = NetBuilder("googlenet", 224, 224, 3)
    x = b.conv(b.input, 64, 7, 2, name="conv1")
    x = b.pool(x, 3, 2, name="pool1")
    x = b.conv(x, 64, 1, 1, name="conv2r")
    x = b.conv(x, 192, 3, 1, name="conv2")
    x = b.pool(x, 3, 2, name="pool2")
    x = _inception(b, x, 64, 96, 128, 16, 32, 32, "i3a")
    x = _inception(b, x, 128, 128, 192, 32, 96, 64, "i3b")
    x = b.pool(x, 3, 2, name="pool3")
    x = _inception(b, x, 192, 96, 208, 16, 48, 64, "i4a")
    x = _inception(b, x, 160, 112, 224, 24, 64, 64, "i4b")
    x = _inception(b, x, 128, 128, 256, 24, 64, 64, "i4c")
    x = _inception(b, x, 112, 144, 288, 32, 64, 64, "i4d")
    x = _inception(b, x, 256, 160, 320, 32, 128, 128, "i4e")
    x = b.pool(x, 3, 2, name="pool4")
    x = _inception(b, x, 256, 160, 320, 32, 128, 128, "i5a")
    x = _inception(b, x, 384, 192, 384, 48, 128, 128, "i5b")
    x = b.global_pool(x)
    x = b.fc(x, 1000, "fc")
    return b.done(x)


# ---------------------------------------------------------------------------
# multi-branch: Transformer / GPT (tokens are rows; attention is seq-global)
# ---------------------------------------------------------------------------

def _tf_layer(b: NetBuilder, x: int, d: int, dff: int, tag: str) -> int:
    qkv = b.conv(x, 3 * d, 1, 1, name=f"{tag}.qkv")
    att = b.attention(qkv, name=f"{tag}.attn")
    # attention output has width d (scores are transient inside the PE array)
    h, w, _ = b.shapes[att]
    b.shapes[att] = (h, 1, d)
    b.g.nodes[att].line_bytes = d
    # score+context matmuls: 2 * S^2 * d MACs
    b.g.nodes[att].macs = 2 * h * h * d
    proj = b.conv(att, d, 1, 1, name=f"{tag}.proj")
    add1 = b.eltwise([proj, x], name=f"{tag}.add1")
    f1 = b.conv(add1, dff, 1, 1, name=f"{tag}.ffn1")
    f2 = b.conv(f1, d, 1, 1, name=f"{tag}.ffn2")
    return b.eltwise([f2, add1], name=f"{tag}.add2")


def transformer(layers: int = 6, d: int = 512, dff: int = 2048,
                seq: int = 512) -> Graph:
    """Vaswani base: 6 encoder + 6 decoder layers with cross-attention."""
    b = NetBuilder("transformer", seq, 1, d)
    x = b.input
    for i in range(layers):
        x = _tf_layer(b, x, d, dff, f"E{i}")
    memory = x
    # decoder input: second virtual source
    y = b.g.add_node("dec_input", seq, d)
    b.shapes[y] = (seq, 1, d)
    for i in range(layers):
        tag = f"D{i}"
        qkv = b.conv(y, 3 * d, 1, 1, name=f"{tag}.qkv")
        att = b.attention(qkv, name=f"{tag}.self")
        h, _, _ = b.shapes[att]
        b.shapes[att] = (h, 1, d)
        b.g.nodes[att].line_bytes = d
        b.g.nodes[att].macs = 2 * h * h * d
        proj = b.conv(att, d, 1, 1, name=f"{tag}.proj")
        add1 = b.eltwise([proj, y], name=f"{tag}.add1")
        # cross-attention: query from decoder (per-token), memory from encoder
        q = b.conv(add1, d, 1, 1, name=f"{tag}.q")
        ca = b.g.add_node(f"{tag}.cross", seq, d, weight_bytes=2 * d * d,
                          macs=2 * seq * seq * d + 2 * seq * d * d)
        b.g.add_edge(q, ca, F=1, s=1)
        b.g.add_edge(memory, ca, kind=FULL)
        b.shapes[ca] = (seq, 1, d)
        proj2 = b.conv(ca, d, 1, 1, name=f"{tag}.cproj")
        add2 = b.eltwise([proj2, add1], name=f"{tag}.add2")
        f1 = b.conv(add2, dff, 1, 1, name=f"{tag}.ffn1")
        f2 = b.conv(f1, d, 1, 1, name=f"{tag}.ffn2")
        y = b.eltwise([f2, add2], name=f"{tag}.add3")
    return b.done(y)


def gpt(layers: int = 12, d: int = 768, dff: int = 3072,
        seq: int = 512, vocab: int = 40478) -> Graph:
    b = NetBuilder("gpt", seq, 1, d)
    x = b.input
    for i in range(layers):
        x = _tf_layer(b, x, d, dff, f"L{i}")
    x = b.conv(x, vocab, 1, 1, name="lm_head")  # per-token projection d->vocab
    return b.done(x)


# ---------------------------------------------------------------------------
# irregular: RandWire (Watts–Strogatz, seeded) and NasNet-A
# ---------------------------------------------------------------------------

def _randwire_stage(b: NetBuilder, x: int, n: int, k: int, p: float,
                    c: int, stride: int, seed: int, tag: str) -> int:
    import networkx as nx

    ws = nx.connected_watts_strogatz_graph(n, k, p, seed=seed)
    order = sorted(ws.nodes())
    # DAG orientation: edge (i, j) with i < j
    ins: Dict[int, List[int]] = {i: [] for i in order}
    outs: Dict[int, List[int]] = {i: [] for i in order}
    for (i, j) in ws.edges():
        i, j = min(i, j), max(i, j)
        ins[j].append(i)
        outs[i].append(j)
    nodes: Dict[int, int] = {}
    for i in order:
        srcs = [nodes[j] for j in ins[i]]
        if not srcs:
            # stage input node (stride applied here)
            inp = b.conv(x, c, 3, stride, name=f"{tag}.n{i}.dw",
                         depthwise=False)
            nodes[i] = inp
            continue
        agg = srcs[0] if len(srcs) == 1 else b.eltwise(srcs, f"{tag}.n{i}.sum")
        # ReLU-sepconv3x3: depthwise + pointwise
        dw = b.conv(agg, 0, 3, 1, name=f"{tag}.n{i}.dw", depthwise=True)
        pw = b.conv(dw, c, 1, 1, name=f"{tag}.n{i}.pw")
        nodes[i] = pw
    sinks = [nodes[i] for i in order if not outs[i]]
    return sinks[0] if len(sinks) == 1 else b.eltwise(sinks, f"{tag}.out")


def randwire(variant: str = "A") -> Graph:
    """RandWire-A (small regime, C=78) / RandWire-B (regular regime, C=109)."""
    c = 78 if variant == "A" else 109
    seed0 = 11 if variant == "A" else 23
    b = NetBuilder(f"randwire_{variant.lower()}", 224, 224, 3)
    x = b.conv(b.input, c // 2, 3, 2, name="stem")
    for si, (n, mult, stride) in enumerate([(32, 1, 2), (32, 2, 2), (32, 4, 2)]):
        x = _randwire_stage(b, x, n=n, k=4, p=0.75, c=c * mult,
                            stride=stride, seed=seed0 + si, tag=f"s{si}")
    x = b.conv(x, 1280, 1, 1, name="head_conv")
    x = b.global_pool(x)
    x = b.fc(x, 1000, "fc")
    return b.done(x)


def _nasnet_sep(b: NetBuilder, x: int, c: int, f: int, s: int, tag: str) -> int:
    dw = b.conv(x, 0, f, s, name=f"{tag}.dw", depthwise=True)
    return b.conv(dw, c, 1, 1, name=f"{tag}.pw")


def _nasnet_adjust(b: NetBuilder, h: int, hm1: int, c: int,
                   tag: str) -> Tuple[int, int]:
    """Cell-entry squeeze: project both states to c channels / matching H."""
    hh = b.shapes[h][0]
    h = b.conv(h, c, 1, 1, name=f"{tag}.sq_h")
    s = max(1, b.shapes[hm1][0] // hh)
    hm1 = b.conv(hm1, c, 1, s, name=f"{tag}.sq_hm1")
    return h, hm1


def _nasnet_normal(b: NetBuilder, h: int, hm1: int, c: int, tag: str) -> int:
    """NasNet-A normal cell (5 blocks, Zoph et al. Fig. 4)."""
    h, hm1 = _nasnet_adjust(b, h, hm1, c, tag)
    b1 = b.eltwise([_nasnet_sep(b, h, c, 3, 1, f"{tag}.b1l"), h],
                   name=f"{tag}.b1")
    b2 = b.eltwise([_nasnet_sep(b, hm1, c, 3, 1, f"{tag}.b2l"),
                    _nasnet_sep(b, h, c, 5, 1, f"{tag}.b2r")],
                   name=f"{tag}.b2")
    b3 = b.eltwise([b.pool(h, 3, 1, name=f"{tag}.b3l"), hm1],
                   name=f"{tag}.b3")
    b4 = b.eltwise([b.pool(hm1, 3, 1, name=f"{tag}.b4l"),
                    b.pool(hm1, 3, 1, name=f"{tag}.b4r")],
                   name=f"{tag}.b4")
    b5 = b.eltwise([_nasnet_sep(b, hm1, c, 5, 1, f"{tag}.b5l"),
                    _nasnet_sep(b, hm1, c, 3, 1, f"{tag}.b5r")],
                   name=f"{tag}.b5")
    return b.concat([b1, b2, b3, b4, b5], name=f"{tag}.cat")


def _nasnet_reduction(b: NetBuilder, h: int, hm1: int, c: int, tag: str) -> int:
    """NasNet-A reduction cell (stride-2 blocks)."""
    h, hm1 = _nasnet_adjust(b, h, hm1, c, tag)
    b1 = b.eltwise([_nasnet_sep(b, hm1, c, 7, 2, f"{tag}.b1l"),
                    _nasnet_sep(b, h, c, 5, 2, f"{tag}.b1r")],
                   name=f"{tag}.b1")
    b2 = b.eltwise([b.pool(h, 3, 2, name=f"{tag}.b2l"),
                    _nasnet_sep(b, hm1, c, 7, 2, f"{tag}.b2r")],
                   name=f"{tag}.b2")
    b3 = b.eltwise([b.pool(h, 3, 2, name=f"{tag}.b3l"),
                    _nasnet_sep(b, hm1, c, 5, 2, f"{tag}.b3r")],
                   name=f"{tag}.b3")
    b4 = b.eltwise([b.pool(b1, 3, 1, name=f"{tag}.b4l"), b2],
                   name=f"{tag}.b4")
    b5 = b.eltwise([_nasnet_sep(b, b1, c, 3, 1, f"{tag}.b5l"), b3],
                   name=f"{tag}.b5")
    return b.concat([b2, b4, b5], name=f"{tag}.cat")


def nasnet(cells_per_stack: int = 4, c0: int = 44) -> Graph:
    """NasNet-A (mobile-ish: N=4, 44 filters)."""
    b = NetBuilder("nasnet", 224, 224, 3)
    x = b.conv(b.input, 32, 3, 2, name="stem")
    hm1, h = x, x
    c = c0
    for stack in range(3):
        if stack > 0:
            c *= 2
            r = _nasnet_reduction(b, h, hm1, c, f"r{stack}")
            hm1, h = h, r
        for i in range(cells_per_stack):
            n = _nasnet_normal(b, h, hm1, c, f"s{stack}c{i}")
            hm1, h = h, n
    x = b.global_pool(h)
    x = b.fc(x, 1000, "fc")
    return b.done(x)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

# The single netlib table.  Every resolution surface — ``build`` here, the
# ``netlib:`` workload scheme in :mod:`repro_torch.api.workloads`, and the CLI's
# ``workloads ls`` — consumes this dict, so the set of names cannot drift
# between them (tests/test_netlib.py pins the parity).
PAPER_MODELS = {
    "vgg16": vgg16,
    "resnet50": resnet50,
    "resnet152": resnet152,
    "googlenet": googlenet,
    "transformer": transformer,
    "gpt": gpt,
    "randwire_a": lambda: randwire("A"),
    "randwire_b": lambda: randwire("B"),
    "nasnet": nasnet,
}


def list_models() -> List[str]:
    return sorted(PAPER_MODELS)


def build(name: str) -> Graph:
    """Build the named paper model; the one netlib resolution path."""
    try:
        builder = PAPER_MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown netlib model {name!r}; known: {list_models()}"
        ) from None
    return builder()
