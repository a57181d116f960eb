"""``python -m raydp_tpu_torch.cluster.head_main <session_dir>`` — head process entry."""

import os
import secrets
import sys

import cloudpickle

from raydp_tpu_torch.cluster.common import TOKEN_FILE, TOKEN_LEN
from raydp_tpu_torch.cluster.head import run_head


def main() -> None:
    session_dir = sys.argv[1]
    # anchor the serving root: the spill-path sanitizer pins file:// block
    # reads/unlinks to THIS session's spill dir
    from raydp_tpu_torch.cluster.common import SESSION_ENV

    os.environ[SESSION_ENV] = session_dir
    # a zygote-forked head inherits the TEMPLATE's tracing state and lock-
    # order history; this session's env (delivered with the fork request)
    # decides — same re-init dance the worker entry does
    from raydp_tpu_torch.obs.tracing import reinit_for_process

    reinit_for_process("head")
    from raydp_tpu_torch import sanitize

    sanitize.reset_lockdep()
    with open(os.path.join(session_dir, "head_boot.pkl"), "rb") as f:
        driver_pid, default_resources = cloudpickle.load(f)
    # the cluster's shared secret, written before any socket exists; the
    # session dir is mkdtemp(0700) so only the session's user can read it
    token_path = os.path.join(session_dir, TOKEN_FILE)
    if not os.path.exists(token_path):
        with open(token_path + ".tmp", "wb") as f:
            f.write(secrets.token_bytes(TOKEN_LEN))
        os.replace(token_path + ".tmp", token_path)
    run_head(session_dir, driver_pid, default_resources)


if __name__ == "__main__":
    main()
