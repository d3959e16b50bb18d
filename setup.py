"""Wheel build: compile the native host runtime into the package.

Role of the reference's setup.py native build + cibuildwheel matrix
(/root/reference/setup.py:70-75, .github/workflows/build_wheels.yml) —
here a single C++ file compiled with g++ into
``aindex_tpu/_native/libaindex_host.so``:

* wheels built on a machine with g++ ship the compiled library AND the
  source (for `aindex_tpu.native.ensure_built` rebuilds);
* when no compiler is present the build still succeeds — the package
  installs with the source only and every native entry point falls back
  to its pure-Python twin (and compiles on demand later if a toolchain
  appears).
"""

import os
import shutil
import subprocess
import warnings

from setuptools import setup
from setuptools.command.build_py import build_py


class build_py_with_native(build_py):
    def run(self):
        super().run()
        here = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(here, "native", "aindex_host.cpp")
        if not os.path.exists(src):
            return
        pkg_native = os.path.join(self.build_lib, "aindex_tpu", "_native")
        os.makedirs(pkg_native, exist_ok=True)
        shutil.copy2(src, os.path.join(pkg_native, "aindex_host.cpp"))
        out = os.path.join(pkg_native, "libaindex_host.so")
        try:
            # no -march=native in distributed wheels: portable baseline.
            # ensure_built() uses this library as shipped; it compiles
            # (with -march=native) only when the library is missing or
            # older than its source
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread",
                 "-shared", "-o", out, src],
                check=True, capture_output=True, timeout=600)
        except (OSError, subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            warnings.warn(
                f"aindex-tpu: native library not compiled ({e}); the "
                f"package installs with pure-Python fallbacks and will "
                f"build the library on demand if a C++ toolchain appears")


setup(cmdclass={"build_py": build_py_with_native})
