"""Reading a captured CUDA graph's kernel nodes (``utils.graphs``), on CPU.

``kernel_nodes`` asks the CUDA driver for the graph's DOT print
(``CUDAGraph.debug_dump``) and ``count_kernel_nodes`` counts, for each
kernel name, the node statements holding it.  The print below is an
excerpt of one an H100 wrote (torch 2.11, CUDA 12.8) for a graph of two
``pair_maps_fwd`` launches, an elementwise kernel, a memset and a
reduction; the counting needs no card.
"""

import pytest
import torch

from mms_answer_selection_tpu_torch.training.dispatch import StepRunner
from mms_answer_selection_tpu_torch.utils.graphs import count_kernel_nodes

FWD = (r"_ZN45_GLOBAL__N__67a728d5_12_pair_maps_cu_5453ee2d20pair_maps_fwd_"
       r"kernelEPKfS1_S1_Pfiiiiiiii\<\<\<\{50,2\},224,96768\>\>\>")
ELEMENTWISE = (r"_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_13AUnary"
               r"FunctorIfffNS0_15binary_internal10MulFunctorIfEEEESt5arrayIPc"
               r"Lm2EEEEviT0_T1_\<\<\<313,128,0\>\>\>")


def _kernel(graph: int, node: int, name: str) -> str:
    return f'''"graph_{graph}_node_{node}"[style="bold" shape="record" label="{{KERNEL
| {{ID | {node} (topoId: 4) | {name}}}
| {{{{node handle | func handle}} | {{0x000000000A43FBA0 | 0x0000000009B144C0}}}}
| {{cooperative | 0}}
| {{priority | 0}}
}}"];
'''


DOT = ('digraph dot {\nsubgraph cluster_1 {\nlabel="graph_1" '
       'graph[style="dashed"];\n'
       + _kernel(1, 0, FWD) + _kernel(1, 1, FWD) + _kernel(1, 2, ELEMENTWISE)
       + '"graph_1_node_3"[style="solid" style="solid" shape="record" '
         'label="{MEMSET\n| {{ID | node handle | dptr} | {3 (topoId: 1) | '
         '0x000000000A441940 | 0x00007F5B30200400}}}"];\n'
       + '"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];\n'
         '"graph_1_node_1" -> "graph_1_node_2" [headlabel=0];\n'
         '"graph_1_node_2" -> "graph_1_node_3" [headlabel=0];\n}\n}\n')


def test_kernel_nodes_are_counted_by_name():
    got = count_kernel_nodes(DOT, ["pair_maps_fwd_kernel",
                                   "pair_maps_bwd_w_kernel",
                                   "vectorized_elementwise_kernel",
                                   "MEMSET"])
    assert got == {"pair_maps_fwd_kernel": 2, "pair_maps_bwd_w_kernel": 0,
                   "vectorized_elementwise_kernel": 1, "MEMSET": 1}


@pytest.mark.parametrize("dot", ["", "digraph dot {\n}\n",
                                 '"graph_1_node_0" -> "graph_1_node_1";\n'])
def test_a_print_without_node_statements_counts_nothing(dot):
    assert count_kernel_nodes(dot, ["pair_maps_fwd_kernel"]) == {
        "pair_maps_fwd_kernel": 0}


def test_a_runner_keeping_graphs_on_the_cpu_steps_eagerly_and_holds_none():
    """``keep_graphs`` only keeps what a capture records: on the CPU the chunk
    runs its eager steps and the runner has no graph to read."""
    w = torch.ones(3)

    def step(params, state, opt_state, batch, it, generators=None):
        p = {"w": params["w"] + batch["x"]}
        return p, state, opt_state, p["w"].sum()

    runner = StepRunner(step, ({"w": w}, {}, {}), iter_size=1,
                        seed=lambda it, j: it, device="cpu", captures=True)
    runner.keep_graphs = True
    losses = runner.run([{"x": torch.ones(3)}, {"x": torch.ones(3)}], 0)
    assert losses.tolist() == [6.0, 9.0] and runner.replays == 0
    with pytest.raises(ValueError):
        runner.graph(2)
