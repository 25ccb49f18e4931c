"""The port's counterparts of the repository's ``scripts/``: the check gate
(``check.sh``), the structural perf sentinels (``perf_smoke.py``), the
first-network acceptance session (``first-network-session.sh``), the lint
wrapper (``lint.sh``) and the real-text corpus builder
(``build_repo_corpus.py``), each driving ``deeplearning_cfn_tpu_torch``."""
