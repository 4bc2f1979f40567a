"""CLI entry point: ``python -m imagent_tpu_torch [flags]`` (PyTorch port
of ``imagent_tpu/__main__.py``).

The same flag surface as the JAX package (``config.py``); flags this
slice does not port are refused. Exit codes follow
``resilience/exitcodes.py``: 0 on a clean finish, 78 (fatal-config) for
invalid or not-yet-ported flags and for ``--backend gpu`` without a CUDA
device, 79 when non-finite steps survive every rollback, 70 for any
other exception.
"""

import sys

from imagent_tpu_torch.config import parse_args


def main(argv=None) -> int:
    cfg = parse_args(argv)
    from imagent_tpu_torch.engine import run
    from imagent_tpu_torch.resilience import exitcodes

    def _announce(code: int) -> int:
        entry = exitcodes.describe(code)
        print(f"exit {code} ({entry.name if entry else '?'})", flush=True)
        return code

    try:
        run(cfg)
    except exitcodes.FatalRunError as e:
        print(f"FATAL ({e.reason}): {e}", flush=True)
        return _announce(e.exit_code)
    except ValueError as e:
        # Config validation: rerunning the same flags reproduces it.
        print(f"FATAL (fatal-config): {e}", flush=True)
        return _announce(exitcodes.FATAL_CONFIG)
    except Exception:
        import traceback

        traceback.print_exc()
        return _announce(exitcodes.FATAL_EXCEPTION)
    return exitcodes.OK


if __name__ == "__main__":
    sys.exit(main())
