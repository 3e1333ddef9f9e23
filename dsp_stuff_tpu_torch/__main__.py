"""Command line of the port -- the analog of the reference's app entry
(main.rs: clap parsing + tracing setup + app launch; its only flag is
--clean).  Headless equivalents, each rendering on the card unless
``--device cpu`` is given:

    python -m dsp_stuff_tpu_torch nodes                   # list node types
    python -m dsp_stuff_tpu_torch render GRAPH.json \\
        [--in IN.wav ...] [--out OUT.wav] [--seconds S] \\
        [--policy fast|parity|exact] [--device cuda|cpu]  # offline render
    python -m dsp_stuff_tpu_torch fit GRAPH.json --in dry.wav \\
        --target wet.wav [--device cuda|cpu]              # gradient fitting
    python -m dsp_stuff_tpu_torch inspect GRAPH.json      # topology summary
    python -m dsp_stuff_tpu_torch debug GRAPH.json --seconds S \\
        [--device cuda|cpu]                               # per-node stats

``--policy exact`` renders with the linear recurrences sample by sample
(the sequential kernel on the card; bitwise the reference's loops with
``--device cpu``).  Without a CUDA device, ``render``, ``fit`` and
``debug`` exit with the message that says to pass ``--device cpu``.

Env: DST_LOG=debug|info|... (the RUST_LOG analog, utils/obs.py).
"""

from __future__ import annotations

import argparse


def _device(args):
    """The resolved --device; exits with the compiler's message when the
    card is asked for and there is none."""
    from dsp_stuff_tpu_torch.compiler.compile import _resolve_device
    try:
        return _resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"dsp_stuff_tpu_torch {args.cmd}: {e}")


def _cmd_nodes(args):
    from dsp_stuff_tpu_torch.registry import REGISTRY, ParamSpec, SelectSpec
    for spec in sorted(REGISTRY, key=lambda s: s.cfg_name):
        params = []
        for p in spec.params:
            if isinstance(p, ParamSpec):
                mod = " (mod)" if p.as_input else ""
                params.append(f"{p.name}[{p.lo}..{p.hi}]{mod}")
            elif isinstance(p, SelectSpec):
                params.append(f"{p.name}{{{'|'.join(p.choices)}}}")
            else:
                params.append(p.name)
        io = f"{len(spec.inputs)}->{len(spec.outputs)}"
        print(f"{spec.cfg_name:<12} {io:<6} {spec.title:<18} "
              f"{', '.join(params)}")


def _cmd_render(args):
    from dsp_stuff_tpu_torch.runtime.session import render_file
    from dsp_stuff_tpu_torch.utils.precision import set_policy
    set_policy(args.policy)
    dev = _device(args)
    outs, aux = render_file(args.graph, in_wavs=args.inputs or None,
                            out_wav=args.out, seconds=args.seconds,
                            out_rate=args.out_rate, stereo_out=args.stereo,
                            resample_inputs=args.resample_inputs, device=dev)
    print(f"rendered {outs.shape[0]} channel(s) x {outs.shape[-1]} samples "
          f"on {dev}" + (f" -> {args.out}" if args.out else ""))
    for key in aux:
        print(f"aux: {key}")


def _cmd_fit(args):
    import torch
    from dsp_stuff_tpu_torch.compiler.compile import compile_graph
    from dsp_stuff_tpu_torch.graph import load_graph, save_graph
    from dsp_stuff_tpu_torch.io import wav as wav_io
    from dsp_stuff_tpu_torch.train.fit import fit, mse_loss, spectral_loss
    from dsp_stuff_tpu_torch.utils.precision import set_policy

    set_policy("fast")
    dev = _device(args)
    g = load_graph(args.graph)
    cg = compile_graph(g, device=dev)
    xin, rate = wav_io.read_wav(getattr(args, "in"))
    tgt, rate2 = wav_io.read_wav(args.target)
    if rate != 48_000 or rate2 != 48_000:
        raise SystemExit("fit: inputs must be 48 kHz")
    T = min(xin.shape[-1], tgt.shape[-1])
    T -= T % 1024
    if T == 0:
        raise SystemExit("fit: input/target must be at least 1024 samples")
    if not cg.input_ids or not cg.output_ids:
        raise SystemExit("fit: graph needs an Input and an Output node")
    if len(cg.input_ids) > 1:
        raise SystemExit("fit: only single-Input graphs are supported "
                         f"(this graph has {len(cg.input_ids)} Input nodes)")
    x = torch.as_tensor(wav_io.to_mono(xin)[:T], device=dev)
    t = torch.as_tensor(wav_io.to_mono(tgt)[:T], device=dev)
    ext = {str(cg.input_ids[0]): x[None]}
    dist = spectral_loss if args.loss == "spectral" else mse_loss
    params, losses = fit(cg, ext, t[None, None, :], steps=args.steps,
                         distance=dist, verbose=True)
    # fold the fitted sliders back into the graph and save
    for nid_s, entry in params.items():
        for name, val in entry.items():
            g.nodes[int(nid_s)].params[name] = float(val)
    out = args.out or args.graph
    save_graph(g, out)
    print(f"fit: final loss {losses[-1]:.3e}; wrote {out}")


def _cmd_inspect(args):
    from dsp_stuff_tpu_torch.graph import load_graph
    g = load_graph(args.graph)
    print(f"{len(g.nodes)} nodes, {len(g.links)} links")
    for nid in sorted(g.nodes):
        n = g.nodes[nid]
        print(f"  [{nid}] {n.cfg_name} "
              f"{ {k: v for k, v in n.params.items() if not isinstance(v, list)} }")
    for l in g.links:
        print(f"  {l.src}.{l.src_port} -> {l.dst}.{l.dst_port}")


def _cmd_debug(args):
    from dsp_stuff_tpu_torch.graph import load_graph
    from dsp_stuff_tpu_torch.utils.obs import debug_render
    dev = _device(args)
    g = load_graph(args.graph)
    T = int((args.seconds or 1.0) * 48_000)
    T += (-T) % 128
    _outs, report = debug_render(g, T=T, device=dev)
    print(f"{'node':>5} {'cfg':<12} {'port':<6} {'ms':>8} {'rms':>10} "
          f"{'max':>10} {'nan':>6} {'inf':>6}")
    for r in report:
        print(f"{r['node']:>5} {r['cfg']:<12} {r['port']:<6} "
              f"{r['ms']:>8.2f} {r['out_rms']:>10.4f} {r['out_max']:>10.4f} "
              f"{r['nan']:>6} {r['inf']:>6}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dsp_stuff_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("nodes", help="list registered node types")

    def device_flag(p):
        p.add_argument("--device", default="cuda",
                       help="torch device to render on (default: cuda, the "
                            "card; cpu for the CPU)")

    rp = sub.add_parser("render", help="offline render of a graph JSON")
    rp.add_argument("graph")
    rp.add_argument("--in", dest="inputs", action="append",
                    help="input WAV (one per Input node, ascending id)")
    rp.add_argument("--out", help="output WAV path")
    rp.add_argument("--seconds", type=float,
                    help="render length for generator graphs")
    rp.add_argument("--policy", default="fast",
                    choices=("fast", "parity", "exact"))
    rp.add_argument("--out-rate", type=int, default=None,
                    help="export sample rate (sinc-16 device-rate path)")
    rp.add_argument("--stereo", action="store_true",
                    help="duplicate a mono render to stereo on export")
    rp.add_argument("--resample-inputs", action="store_true",
                    help="accept non-48kHz input WAVs (sinc-16 ingest)")
    device_flag(rp)

    fp = sub.add_parser("fit", help="gradient-fit graph sliders to a target")
    fp.add_argument("graph")
    fp.add_argument("--in", required=True, help="input WAV (dry signal)")
    fp.add_argument("--target", required=True, help="target WAV to match")
    fp.add_argument("--steps", type=int, default=300)
    fp.add_argument("--loss", default="mse", choices=("mse", "spectral"))
    fp.add_argument("--out", help="output graph JSON (default: in place)")
    device_flag(fp)

    ip = sub.add_parser("inspect", help="print graph topology")
    ip.add_argument("graph")

    dp = sub.add_parser("debug", help="per-node stats render")
    dp.add_argument("graph")
    dp.add_argument("--seconds", type=float, default=1.0)
    device_flag(dp)

    args = ap.parse_args(argv)
    {"nodes": _cmd_nodes, "render": _cmd_render, "fit": _cmd_fit,
     "inspect": _cmd_inspect, "debug": _cmd_debug}[args.cmd](args)


if __name__ == "__main__":
    main()
