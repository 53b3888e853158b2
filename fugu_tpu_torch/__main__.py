"""Entry point: argv dispatch — CLI with args, server without
(upstream `src/main.rs:11-31`)."""

import sys

from fugu_tpu_torch.cli import run_cli

if __name__ == "__main__":
    sys.exit(run_cli(sys.argv[1:] if len(sys.argv) > 1 else ["serve"]))
