"""Result aggregator CLI (parity with reference parse_eval_results.py).

    python -m spatialaudiogen_tpu_torch.cli.parse_eval_results EVAL_DETAILED_TXT
"""

from spatialaudiogen_tpu_torch.eval.parse_results import main

if __name__ == "__main__":
    main()
