"""Operator CLIs (the port's copy of ``ceph_tpu.tools``).

- ec_benchmark: ceph_erasure_code_benchmark contract
- osdmaptool: --print and the --test-map-pgs bulk placement harness
- crushtool: --build, -d/-c (the text compiler) and --test
- psim: the placement simulator
- perf_msgr: the messenger's throughput harness
- objectstore_tool: offline store surgery (list, info, export, import)
- kvstore_tool: offline kv surgery over a FileDB
"""
