# Convenience targets (the reference builds with one g++ line, Makefile:4-5;
# XLA jits the device compute at run time; `make native` builds the
# host-side C++ image codec, which io/native_codec.py otherwise builds on
# first use).

.PHONY: test test-fast test-gpu bench report parity smoke native

native:
	g++ -O3 -shared -fPIC -o smallvcm_tpu/native/libsvcmcodec.so \
		smallvcm_tpu/native/codec.cpp

test:
	python -m pytest tests/ -q

# CI profile: skips the compile-heavy sharded/multihost/AD-FD tests (each
# slow test is a scaled-up flavor of coverage that also runs fast: sharding
# equality also runs at 8-dev in the graft dryrun, grad correctness also
# runs via the cheap pt FD check).
test-fast:
	@python -c "import xdist" 2>/dev/null \
	    && python -m pytest tests/ -q -m "not slow" -n 2 \
	    || python -m pytest tests/ -q -m "not slow"

# On a GPU host: the GPU-compiled merge and small-render tests.
test-gpu:
	JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -q -m gpu

bench:
	python bench.py

report:
	python -m smallvcm_tpu.cli --report -i 10

parity:
	python scripts/parity.py --ref-src $(REF_SRC) --iters 10 --out PARITY.md

# On a GPU host: the main path end to end (see chip_smoke.py).
smoke:
	python chip_smoke.py
