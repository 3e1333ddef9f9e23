"""Strongly-connected components + condensation topological order.

The reference has no scheduler at all -- every node spins in its own tokio
task and rivulet backpressure orders execution emergently
(runtime.rs:718-731, SURVEY.md section 1).  The compiler replaces that with
static analysis: Tarjan SCC over the node graph, feedback cycles condensed
into single scheduling units, and a topological order over the condensation.
"""

from __future__ import annotations


def tarjan_scc(vertices, edges):
    """Iterative Tarjan.  vertices: iterable of hashables; edges: dict
    v -> iterable of successors.  Returns list of SCCs (each a list of
    vertices) in *reverse* topological order of the condensation."""
    index_counter = [0]
    stack: list = []
    lowlink: dict = {}
    index: dict = {}
    on_stack: dict = {}
    result: list[list] = []

    for source in vertices:
        if source in index:
            continue
        work = [(source, iter(edges.get(source, ())))]
        index[source] = lowlink[source] = index_counter[0]
        index_counter[0] += 1
        stack.append(source)
        on_stack[source] = True
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = lowlink[w] = index_counter[0]
                    index_counter[0] += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(edges.get(w, ()))))
                    advanced = True
                    break
                elif on_stack.get(w):
                    lowlink[v] = min(lowlink[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[v])
            if lowlink[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                result.append(comp)
    return result


def condensation_topo_order(vertices, edges):
    """Returns SCCs in topological order (producers before consumers)."""
    sccs = tarjan_scc(vertices, edges)
    # Tarjan emits SCCs in reverse topological order
    return list(reversed(sccs))
