"""Command-line tools of the port, each run as
`python -m mlsgpu_tpu_torch.tools.<name>`: PLY utilities (plyio,
plymanifold, plypntcat), statistics and timeplot readers (analyze_stats,
analyze_timeplot, draw_timeplot, simulate), the chunked-output verifier
(verify_chunks), the bench cloud (cloud) and the benchmarks built on it
(bench_ooc, bench_stage, bench_split)."""
