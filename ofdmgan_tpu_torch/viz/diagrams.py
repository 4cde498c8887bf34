"""Architecture diagrams: Graphviz ``.dot`` sources and matplotlib block
renders (counterpart of ``ofdmgan_tpu/viz/diagrams.py``; the port keeps
its own copy).

The sources are the JAX package's, byte for byte: they draw the
reference system's models, its training step, its TPU pipeline and its
module tree. No graphviz binary is assumed, so each diagram is written as
``.dot`` source and drawn by a dependency-free layered layout in
matplotlib, imported when drawing.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple


def _dot(name: str, nodes: Sequence[Tuple[str, str]], edges: Sequence[Tuple[str, str]],
         rankdir: str = "LR") -> str:
    lines = [f"digraph {name} {{", f'  rankdir={rankdir};',
             '  node [shape=box, style="rounded,filled", fillcolor="#e8f0fe"];']
    for nid, label in nodes:
        lines.append(f'  {nid} [label="{label}"];')
    for a, b in edges:
        lines.append(f"  {a} -> {b};")
    lines.append("}")
    return "\n".join(lines)


def generator_diagram() -> str:
    nodes = [
        ("input", "Input\\n[B,16,2] I/Q"),
        ("enc1", "Enc1\\nConv 2->4 k3 s2\\nLeakyReLU"),
        ("bneck", "Bottleneck\\nConv 4->8 k3 s2\\nLeakyReLU"),
        ("up1", "Upsample x2"),
        ("dec1", "Dec1\\nConv 8->4 k3 s1\\nLeakyReLU"),
        ("skip", "Skip Add (+)"),
        ("up2", "Upsample x2"),
        ("outc", "OutConv 4->2 k3"),
        ("tanh", "tanh"),
        ("output", "Output\\n[B,16,2]"),
    ]
    edges = [("input", "enc1"), ("enc1", "bneck"), ("bneck", "up1"), ("up1", "dec1"),
             ("dec1", "skip"), ("enc1", "skip"), ("skip", "up2"), ("up2", "outc"),
             ("outc", "tanh"), ("tanh", "output")]
    return _dot("MiniGenerator", nodes, edges)


def discriminator_diagram() -> str:
    nodes = [
        ("cand", "Candidate [B,16,2]"),
        ("cond", "Condition [B,16,2]"),
        ("cat", "Concat -> [B,16,4]"),
        ("c1", "Conv1 4->8 k3 s2\\nLeakyReLU"),
        ("c2", "Conv2 8->16 k3 s2\\nLeakyReLU"),
        ("pool", "Global SUM pool\\n[B,16]"),
        ("dense", "Dense 16->1"),
        ("score", "Wasserstein score"),
    ]
    edges = [("cand", "cat"), ("cond", "cat"), ("cat", "c1"), ("c1", "c2"),
             ("c2", "pool"), ("pool", "dense"), ("dense", "score")]
    return _dot("MiniDiscriminator", nodes, edges)


def training_flow_diagram() -> str:
    nodes = [
        ("key", "PRNG key"),
        ("datagen", "Fused on-device datagen\\nIFFT + impairments + channel"),
        ("gen", "Generator G"),
        ("critic", "Critic D"),
        ("gp", "Gradient penalty\\n(nested jax.grad)"),
        ("dloss", "L_D = E[D(fake)]-E[D(real)]+10GP\\n(x5 critic steps, lax.scan)"),
        ("gloss", "L_G = -E[D(fake)]+100L1"),
        ("adam", "Adam(0, 0.9) updates"),
    ]
    edges = [("key", "datagen"), ("datagen", "gen"), ("gen", "critic"),
             ("datagen", "critic"), ("critic", "gp"), ("gp", "dloss"),
             ("critic", "dloss"), ("critic", "gloss"), ("gen", "gloss"),
             ("dloss", "adam"), ("gloss", "adam")]
    return _dot("CWGANGPTraining", nodes, edges)


def tpu_pipeline_diagram() -> str:
    """Hardware overview — the TPU analog of draw_fpga_overview
    (architecture_diagrams.py:268-314)."""
    nodes = [
        ("host", "Host\\n(Python, config, checkpoints)"),
        ("jit", "XLA-compiled step\\n(one dispatch / N steps)"),
        ("mxu", "MXU matmuls\\n(conv-as-dense [B,32]x[32,32])"),
        ("vpu", "VPU elementwise\\n(LeakyReLU/tanh/noise)"),
        ("hbm", "HBM\\n(params + optimizer state)"),
        ("ici", "ICI collectives\\n(pmean grads, shard_map dp)"),
        ("quant", "Q1.7/Q8.8 int path\\n(intsim + C++ cosim + ROM codegen)"),
    ]
    edges = [("host", "jit"), ("jit", "mxu"), ("jit", "vpu"), ("hbm", "mxu"),
             ("jit", "ici"), ("jit", "quant")]
    return _dot("TPUPipeline", nodes, edges)


def module_hierarchy_diagram() -> str:
    nodes = [
        ("pkg", "ofdmgan_tpu"),
        ("signal", "signal/\\nqam ofdm channel impairments datagen"),
        ("models", "models/\\ngenerator critic"),
        ("ops", "ops/\\ndense_conv"),
        ("training", "training/\\nwgan_gp trainer schedules"),
        ("parallel", "parallel/\\nmesh shard_map"),
        ("quant", "quant/\\nqformat fakequant intsim export rom_codegen"),
        ("eval", "eval/\\nmetrics equalizers benchmark"),
        ("verify", "verify/\\narch_check golden proof cosim"),
        ("native", "native/\\nfixsim.cpp"),
    ]
    edges = [("pkg", n) for n, _ in nodes[1:]]
    return _dot("ModuleHierarchy", nodes, edges, rankdir="TB")


def full_architecture_diagram() -> str:
    nodes = [
        ("noisy", "Noisy I/Q (condition)"),
        ("gen", "MiniGenerator\\n258 params"),
        ("fake", "Enhanced I/Q"),
        ("clean", "Clean I/Q (real)"),
        ("disc", "MiniDiscriminator\\n521 params"),
        ("score", "Real/Fake score"),
    ]
    edges = [("noisy", "gen"), ("gen", "fake"), ("fake", "disc"),
             ("clean", "disc"), ("noisy", "disc"), ("disc", "score")]
    return _dot("CWGAN_GP", nodes, edges)


_DIAGRAMS = {
    "full_architecture": full_architecture_diagram,
    "generator_detailed": generator_diagram,
    "discriminator_detailed": discriminator_diagram,
    "training_flow": training_flow_diagram,
    "tpu_overview": tpu_pipeline_diagram,
    "module_hierarchy": module_hierarchy_diagram,
}


def dot_sources() -> Dict[str, str]:
    """Every diagram's ``.dot`` source by name (no plotting package needed)."""
    return {name: fn() for name, fn in _DIAGRAMS.items()}


def _render_dot_with_matplotlib(dot_text: str, path: Path, title: str):
    """Dependency-free block rendering: nodes in topological layers."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nodes = dict(re.findall(r'(\w+) \[label="(.+?)"\];', dot_text))
    edges = re.findall(r"(\w+) -> (\w+);", dot_text)
    order = list(nodes)
    # simple layered layout by longest-path depth
    depth = {n: 0 for n in order}
    for _ in range(len(order)):
        for a, b in edges:
            depth[b] = max(depth[b], depth[a] + 1)
    by_depth: Dict[int, List[str]] = {}
    for n in order:
        by_depth.setdefault(depth[n], []).append(n)
    pos = {}
    for d, ns in by_depth.items():
        for i, n in enumerate(ns):
            pos[n] = (d * 3.0, -(i - (len(ns) - 1) / 2) * 1.6)
    fig, ax = plt.subplots(figsize=(2 + 3 * (max(by_depth) + 1) * 0.9, 6))
    for a, b in edges:
        (x1, y1), (x2, y2) = pos[a], pos[b]
        ax.annotate("", xy=(x2 - 0.9, y2), xytext=(x1 + 0.9, y1),
                    arrowprops=dict(arrowstyle="->", color="gray"))
    for n, (x, y) in pos.items():
        ax.text(x, y, nodes[n].replace("\\n", "\n"), ha="center", va="center",
                fontsize=8, bbox=dict(boxstyle="round,pad=0.4", fc="#e8f0fe", ec="#4472c4"))
    ax.set_title(title)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def generate_all_diagrams(output_dir: str = "docs/figures/architecture") -> List[str]:
    """Emit every diagram as .dot + .png (architecture_diagrams.py:357-387)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for name, dot in dot_sources().items():
        (out / f"{name}.dot").write_text(dot + "\n")
        _render_dot_with_matplotlib(dot, out / f"{name}.png", name.replace("_", " "))
        written += [f"{name}.dot", f"{name}.png"]
    return written
