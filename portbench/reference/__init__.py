"""The benchmark's plain reference: NumPy and plain PyTorch, importing
nothing of the program.  ``oracle.py`` is the sequential per-sample
oracle, ``blocks.py`` the same semantics vectorised, and each
``<config>.py`` composes one configuration's graph from its file's
sliders."""

import importlib


def composition(config: str):
    """The module that composes configuration ``config``."""
    return importlib.import_module(f"{__name__}.{config}")


def sliders(cfg: dict) -> dict:
    """{node id (str): {name: value}} of the graph in a configuration
    file, as its JSON holds them (the port-id maps left out)."""
    skip = {"id", "inputs", "outputs", "selected_host", "selected_device"}
    return {str(n["id"]): {k: v for k, v in n["cfg"].items() if k not in skip}
            for n in cfg["graph"]["nodes"]}


def typename(cfg: dict, nid) -> str:
    return next(n["typename"] for n in cfg["graph"]["nodes"]
                if n["id"] == int(nid))
