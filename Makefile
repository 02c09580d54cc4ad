# Standard entry points.  The CPU test target forces JAX_PLATFORMS=cpu with
# 8 virtual devices (multi-device sharding tests without a multi-GPU host);
# the other targets use whatever accelerator JAX finds (the GPU).

PY := python

.PHONY: test test-gpu smoke smoke-four bench probes \
        experiment experiment-exact pod-demo dryrun native clean

test:            ## full CPU suite (parity, kernels in interpret mode, sharding)
	$(PY) -m pytest tests/ -q

test-gpu:        ## GPU-marked tests (compiled Triton kernels) on a GPU
	OCO_TESTS_GPU=1 $(PY) -m pytest tests/ -m gpu -q

smoke:           ## end-to-end check of every main path on one GPU
	$(PY) chip_smoke.py

smoke-four:      ## the sharded sweeps on four GPUs
	$(PY) chip_smoke.py --four-cards

bench:           ## headline metric (one JSON line)
	$(PY) bench.py

probes:          ## measurement probes behind docs/BENCHMARKS.md claims
	$(PY) scripts/checkify_pricing.py
	$(PY) scripts/ssn_onchip_probe.py

experiment:      ## reference-scale pipeline (figures + results.json)
	$(PY) -m online_convex_optimization.experiments.driver \
	    --t-max 1000 --g-runs 1000 --out-dir results

experiment-exact:## exact-FTL pipeline (exact_ftl_driver.py equivalent)
	$(PY) -m online_convex_optimization.experiments.driver \
	    --exact --g-runs 200 --out-dir results

pod-demo:        ## large-scale g sweep (1M device-generated seqs x eta grid)
	$(PY) -m online_convex_optimization.experiments.pod_demo

dryrun:          ## single-device entry + multi-device dry run
	$(PY) __graft_entry__.py

native:          ## build the C++ runtime library
	$(PY) -c "from online_convex_optimization.utils import native; native.load(); print('native OK:', native.num_threads(), 'threads')"

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; true
