"""MoE expert FFN as a block-diagonal SpMM on the PyTorch/CUDA port (the
paper's blocked regime; the port of ``examples/moe_block_sparse.py``).

Routes a token batch with a top-k router, sorts the routed rows by expert
into 128-row blocks, runs the grouped-matmul kernel (its plain version on
the CPU), checks every routed row against its expert's dense product,
and prints the roofline placement on the H100.

    PYTHONPATH=src python examples/torch_moe_block_sparse.py       # the card
    PYTHONPATH=src python examples/torch_moe_block_sparse.py --device cpu
"""
import sys

from repro_torch.launch import moe_block


def main(argv=None):
    args = moe_block.parser().parse_args(argv)
    rec = moe_block.run(args)
    print("(cf. the paper's Eq. 4: block-diagonal dispatch => z = t, the "
          "best case of the blocked-sparsity regime)")
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
