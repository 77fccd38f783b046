"""python -m cudf_tpu_torch.pandas <script.py> [args...]: run a pandas script
unchanged with the accelerator installed (the cudf.pandas __main__
analog). Its frames go to the CUDA card, and the first one raises when
there is none, unless the script calls ``install(device=...)`` itself."""
import runpy
import sys

from ..pandas_accel import install_hook


def main():
    if len(sys.argv) < 2:
        print("usage: python -m cudf_tpu_torch.pandas <script.py> [args...]",
              file=sys.stderr)
        sys.exit(2)
    install_hook()
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")


if __name__ == "__main__":
    main()
