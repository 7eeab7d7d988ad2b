#!/bin/bash
# Build the native packer shared library.
#
# Owns the flag set and the ISA sidecar for EVERY build of this library:
# tools/profile_pack.py reuses it with LDT_SRC/LDT_EXTRA_FLAGS for the
# instrumented twin, so production and profile binaries can never drift
# to different compile flags.
#
#   $1               output .so name (default libldtpack.so)
#   LDT_SRC          packer source (default packer.cc)
#   LDT_EXTRA_FLAGS  extra compile flags (e.g. -DLDT_PROF)
#   LDT_GLUE_OUT     marshalling-helper .so name (default libldtglue.so)
set -e
cd "$(dirname "$0")"
GLUE="${LDT_GLUE_OUT:-libldtglue.so}"

# ISA sidecar writer. LOUD on failure: a silently missing sidecar used
# to force a rebuild every process; the loader now treats missing as
# "unknown, load anyway" (read-only installs), but an unwritable build
# dir is still worth a warning — this build just wrote a .so there.
write_sidecar() {
    if ! { uname -m; grep -m1 '^flags' /proc/cpuinfo 2>/dev/null | md5sum; } \
            > "$1"; then
        echo "WARNING: could not write ISA sidecar $1;" \
             "the loader will treat $2 as unknown-ISA and load it" \
             "anyway (SIGILL risk if this tree moves to different" \
             "hardware)" >&2
    fi
}

if [ "${1:-}" = "--glue-only" ]; then
    # rebuild ONLY the marshalling helper: never rewrite libldtpack.so
    # in place — it may be dlopen'd by the calling process already.
    # LDT_PYINC: the CALLING interpreter's header dir (native/__init__
    # passes it) — PATH python3 may be a different CPython, and glue
    # compiled against the wrong headers would mis-marshal silently.
    PYINC="${LDT_PYINC:-$(python3 -c 'import sysconfig; print(sysconfig.get_paths()["include"])' \
            2>/dev/null || true)}"
    if [ -n "$PYINC" ] && [ -f "$PYINC/Python.h" ]; then
        gcc -O2 -shared -fPIC -I"$PYINC" -o "$GLUE" pyglue.c
        write_sidecar "$GLUE.host" "$GLUE"
        echo "built $(pwd)/$GLUE"
    fi
    exit 0
fi
OUT="${1:-libldtpack.so}"
# -march=native: the library is always built on the host that runs it
# (build-on-demand via native/__init__.py; the wheel ships sources).
# The .host sidecar records the build host's ISA so the loader rebuilds
# instead of SIGILL-ing when a copied working tree lands on a host with
# a different instruction set (native/__init__.py _host_isa()).
g++ -O3 -march=native -funroll-loops ${LDT_EXTRA_FLAGS:-} \
    -shared -fPIC -std=c++17 \
    -o "$OUT" "${LDT_SRC:-packer.cc}" epilogue.cc -lpthread
write_sidecar "$OUT.host" "$OUT"
echo "built $(pwd)/$OUT"
# Optional GIL-held marshalling helper (ctypes.PyDLL; symbols resolve
# from the running interpreter, no libpython link). Best effort: hosts
# without CPython headers keep the pure-Python marshalling path.
PYINC="$(python3 -c 'import sysconfig; print(sysconfig.get_paths()["include"])' \
        2>/dev/null || true)"
if [ -n "$PYINC" ] && [ -f "$PYINC/Python.h" ]; then
    if gcc -O2 -shared -fPIC -I"$PYINC" -o "$GLUE" pyglue.c; then
        write_sidecar "$GLUE.host" "$GLUE"
        echo "built $(pwd)/$GLUE"
    else
        echo "WARNING: glue build failed; keeping the pure-Python" \
             "marshalling path" >&2
    fi
fi
