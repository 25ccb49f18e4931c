"""Worker startup-script rendering — the cfn-init configSet analog.

The reference boots every node through UserData -> cfn-init running an
ordered configSet (``Setup = [efs-config, download-setup,
deeplearning-config]``, deeplearning.template:490-567); the Mask R-CNN
stack extends it to 9 worker / 12 master steps adding S3 data+code staging
with an EFS-vs-EBS placement condition guarded by a marker file
(mask-rcnn-cfn.yaml:774-827,1039-1172) and conda-env auto-activation
(:199-221).

Here the same choreography renders to ONE bash script from the typed spec
(no per-step cloud metadata), because a TPU slice's workers all boot the
same image and the script is delivered via VM metadata.  Step order is
preserved from the reference:

1. storage-config   — mount shared storage (efs-config analog)
2. staging-download — fetch dataset/code artifacts from the object store,
                      marker-guarded shared-vs-local placement
3. env-setup        — pinned pip deps + commands + login-shell activation
4. agent            — exec the bootstrap/discovery agent (the
                      deeplearning-config step running dl_cfn_setup_v2.py)

Counterpart of ``deeplearning_cfn_tpu/cluster/startup.py``, copied: the port imports
nothing of the JAX package.  The agent step execs the port's
``cluster.agent_main``, which reaches its control plane, the broker, at the
address and token stamped into the VM's metadata.
"""

from __future__ import annotations

import shlex

from deeplearning_cfn_tpu_torch.config.schema import ClusterSpec
from deeplearning_cfn_tpu_torch.provision.provisioner import (
    worker_group_name,
    worker_group_names,
)

# Marker file guarding one-time shared-storage data placement — the
# data.txt trick of mask-rcnn-cfn.yaml:784-789 (cfn-init `test:` guards).
DATA_MARKER = ".dlcfn-data-staged"


def render_startup_script(spec: ClusterSpec) -> str:
    """Render the full worker boot script for a cluster spec."""
    lines: list[str] = [
        "#!/bin/bash",
        "set -euo pipefail",
        # Log like cloud-init: everything teed to a well-known path
        # (deeplearning.template:549,645).
        "exec > >(tee -a /var/log/dlcfn-startup.log) 2>&1",
        f"export DLCFN_CLUSTER={shlex.quote(spec.name)}",
    ]
    lines += _storage_steps(spec)
    lines += _staging_steps(spec)
    lines += _setup_steps(spec)
    lines += _agent_step(spec)
    return "\n".join(lines) + "\n"


def _storage_steps(spec: ClusterSpec) -> list[str]:
    mount = shlex.quote(spec.storage.mount_point)
    steps = [f"mkdir -p {mount}"]
    if spec.storage.kind == "filestore":
        # efs-config analog: install client, mount, chown
        # (deeplearning.template:524-538).  The address is delivered via VM
        # metadata after storage creation; guard so a missing value degrades
        # to a warning instead of aborting the boot under `set -u`.
        steps += [
            'DLCFN_FILESTORE_ADDR="${DLCFN_FILESTORE_ADDR:-'
            "$(curl -sf -H 'Metadata-Flavor: Google' "
            "http://metadata.google.internal/computeMetadata/v1/instance/attributes/dlcfn-filestore-addr "
            '|| true)}"',
            "if [ -n \"$DLCFN_FILESTORE_ADDR\" ]; then "
            "command -v mount.nfs >/dev/null || "
            "(apt-get update -qq && apt-get install -y -qq nfs-common); "
            f'mount -t nfs -o rw,async "$DLCFN_FILESTORE_ADDR":/share {mount} '
            f"&& chown -R \"$(id -un)\" {mount} "
            "|| echo 'WARN: filestore mount failed'; "
            "else echo 'WARN: no filestore address in metadata'; fi",
        ]
    elif spec.storage.kind == "gcs":
        steps += [
            'DLCFN_GCS_BUCKET="${DLCFN_GCS_BUCKET:-'
            "$(curl -sf -H 'Metadata-Flavor: Google' "
            "http://metadata.google.internal/computeMetadata/v1/instance/attributes/dlcfn-gcs-bucket "
            '|| true)}"',
            "if [ -n \"$DLCFN_GCS_BUCKET\" ] && command -v gcsfuse >/dev/null; then "
            f'gcsfuse --implicit-dirs "$DLCFN_GCS_BUCKET" {mount} '
            "|| echo 'WARN: gcs mount failed'; "
            "else echo 'WARN: gcs bucket unset or gcsfuse missing'; fi",
        ]
    return steps


def _staging_steps(spec: ClusterSpec) -> list[str]:
    st = spec.staging
    if not st.bucket:
        return []
    base = f"gs://{st.bucket}/{st.prefix}"
    steps: list[str] = []
    if st.datasets:
        if st.data_on_shared_storage:
            # One worker stages for everyone (EFSServesData=True path,
            # mask-rcnn-cfn.yaml:1039-1068).  `mkdir` of the lock dir is the
            # atomic election on shared NFS; losers wait for the completion
            # marker so no one execs the agent against half-extracted data.
            data_dir = f"{spec.storage.mount_point}/data"
            marker = f"{data_dir}/{DATA_MARKER}"
            lock = f"{data_dir}/.dlcfn-stage-lock"
            steps.append(f"mkdir -p {shlex.quote(data_dir)}")
            fetches = " && ".join(
                f"gsutil -m cp {shlex.quote(f'{base}/{art}')} - | tar -x -C {shlex.quote(data_dir)}"
                for art in st.datasets
            )
            steps.append(
                f"if mkdir {shlex.quote(lock)} 2>/dev/null; then "
                f"{fetches} && touch {shlex.quote(marker)}; "
                f"else for i in $(seq 1 360); do "
                f"[ -f {shlex.quote(marker)} ] && break; sleep 10; done; "
                f"[ -f {shlex.quote(marker)} ] || echo 'WARN: staging wait timed out'; fi"
            )
        else:
            # Every worker stages to local disk (EFSServesData=False /
            # EBS path, mask-rcnn-cfn.yaml:774-789).
            data_dir = "/mnt/disks/data"
            steps.append(f"mkdir -p {data_dir}")
            for art in st.datasets:
                steps.append(
                    f"gsutil -m cp {shlex.quote(f'{base}/{art}')} - | tar -x -C {data_dir}"
                )
    for art in st.code:
        # Code lands in the home dir on every worker, like the tensorpack
        # tar (mask-rcnn-cfn.yaml:1107-1130).
        steps.append(
            f"gsutil -m cp {shlex.quote(f'{base}/{art}')} - | tar -x -C \"$HOME\""
        )
    return steps


def _setup_steps(spec: ClusterSpec) -> list[str]:
    setup = spec.setup
    steps: list[str] = []
    if setup.pip_packages:
        # Pinned dependency set on each worker (setup.sh:1-19 analog).
        pkgs = " ".join(shlex.quote(p) for p in setup.pip_packages)
        steps.append(f"python3 -m pip install --no-input -q {pkgs}")
    steps.extend(setup.commands)
    if setup.activate_env:
        # ActivateCondaEnv analog: auto-activate in login shells
        # (mask-rcnn-cfn.yaml:199-221 writes .bash_login).
        act = shlex.quote(f"source {setup.activate_env}/bin/activate")
        steps.append(f"echo {act} >> \"$HOME/.bash_login\"")
    return steps


def _agent_step(spec: ClusterSpec) -> list[str]:
    # deeplearning-config analog: run the discovery agent with the full
    # cluster identity in env — the AWS_DL_* injection of
    # deeplearning.template:546-564.  Worker index comes from TPU VM
    # metadata (every worker of a slice learns its rank from
    # `agent-worker-number`); the broker address is stamped into instance
    # attributes by the controller at create time.  Env vars already set
    # (e.g. by a test harness or a custom image) win over metadata.
    md = (
        "curl -sf -H 'Metadata-Flavor: Google' "
        "http://metadata.google.internal/computeMetadata/v1/instance/"
    )
    return [
        # Retry the metadata fetch, then REFUSE to boot rather than guess:
        # a worker that defaulted to index 0 would run a second coordinator
        # and consume the single group-setup message the real coordinator
        # is waiting for (wait_for_group_success deletes what it reads).
        'for _i in 1 2 3 4 5; do '
        f'DLCFN_WORKER_INDEX="${{DLCFN_WORKER_INDEX:-$({md}attributes/agent-worker-number || true)}}"; '
        '[ -n "$DLCFN_WORKER_INDEX" ] && break; sleep 2; done',
        'if [ -z "$DLCFN_WORKER_INDEX" ]; then '
        "echo 'ERROR: worker index unavailable (metadata + env)'; exit 1; fi",
        'for _i in 1 2 3 4 5; do '
        f'DLCFN_BROKER="${{DLCFN_BROKER:-$({md}attributes/dlcfn-broker || true)}}"; '
        '[ -n "$DLCFN_BROKER" ] && break; sleep 2; done',
        'if [ -z "$DLCFN_BROKER" ]; then '
        "echo 'ERROR: broker address unavailable (metadata + env)'; exit 1; fi",
        # AUTH token rides the same metadata channel, with the same
        # retry discipline as the address fetch (transient metadata-server
        # unavailability at boot must not strand an auth-required
        # cluster).  curl exit 22 = an HTTP error (404: the attribute is
        # legitimately absent — open broker, older stack): stop
        # immediately instead of burning 10 s of retries on a value that
        # will never appear; any other failure is transient and retries.
        # `set -u` safety: the variable is usually unset here, so every
        # reference defaults it; `set -e` safety: the curl assignment runs
        # under `|| _rc=$?` so a failure reaches the retry logic instead
        # of aborting the boot script at the assignment.
        'if [ -z "${DLCFN_BROKER_TOKEN:-}" ]; then for _i in 1 2 3 4 5; do '
        f'_rc=0; _tok="$({md}attributes/dlcfn-broker-token)" || _rc=$?; '
        'if [ "$_rc" = "0" ]; then DLCFN_BROKER_TOKEN="$_tok"; break; fi; '
        '[ "$_rc" = "22" ] && break; sleep 2; done; fi',
        'DLCFN_BROKER_TOKEN="${DLCFN_BROKER_TOKEN:-}"',
        # Slice ordinal (multi-slice: one queued resource per slice, each
        # with its own worker 0) — only slice 0's worker 0 coordinates.
        f'DLCFN_SLICE="${{DLCFN_SLICE:-$({md}attributes/dlcfn-slice || true)}}"',
        'if [ "$DLCFN_WORKER_INDEX" = "0" ] && [ "${DLCFN_SLICE:-0}" = "0" ]; '
        'then DLCFN_ROLE="${DLCFN_ROLE:-coordinator}"; '
        'else DLCFN_ROLE="${DLCFN_ROLE:-worker}"; fi',
        f'DLCFN_GROUPS="${{DLCFN_GROUPS:-{shlex.quote(",".join(worker_group_names(spec.name, spec.pool.slices)))}}}"',
        f'DLCFN_MIN_SLICES="${{DLCFN_MIN_SLICES:-{spec.pool.min_slices or ""}}}"',
        f'DLCFN_STORAGE_MOUNT="${{DLCFN_STORAGE_MOUNT:-{shlex.quote(spec.storage.mount_point)}}}"',
        f'DLCFN_BOOTSTRAP_BUDGET_S="${{DLCFN_BOOTSTRAP_BUDGET_S:-{spec.timeouts.bootstrap_budget_s:.0f}}}"',
        f'DLCFN_POLL_INTERVAL_S="${{DLCFN_POLL_INTERVAL_S:-{spec.timeouts.poll_interval_s:g}}}"',
        "export DLCFN_WORKER_INDEX DLCFN_BROKER DLCFN_BROKER_TOKEN "
        "DLCFN_ROLE DLCFN_SLICE "
        "DLCFN_GROUPS DLCFN_MIN_SLICES DLCFN_STORAGE_MOUNT "
        "DLCFN_BOOTSTRAP_BUDGET_S DLCFN_POLL_INTERVAL_S",
        "exec python3 -m deeplearning_cfn_tpu_torch.cluster.agent_main",
    ]
