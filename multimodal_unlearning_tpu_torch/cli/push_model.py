"""Hub publisher's layout check: the port's copy of
``multimodal_unlearning_tpu/cli/push_model.py`` without the upload.

  python -m multimodal_unlearning_tpu_torch.cli.push_model <checkpoint_dir> <repo_id>

Exits 2 without both arguments and 1 when the directory holds no
``model.safetensors`` (not an HF-layout checkpoint); otherwise reports the
files it would push.  The upload itself needs network access and
``huggingface_hub``, and is not ported.
"""

from __future__ import annotations

import sys
from pathlib import Path


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) < 2:
        print("usage: push_model <checkpoint_dir> <repo_id>")
        sys.exit(2)
    ckpt_dir, repo_id = Path(args[0]), args[1]
    files = sorted(p.name for p in ckpt_dir.glob("*") if p.is_file())
    if "model.safetensors" not in files:
        print(f"{ckpt_dir} is not an HF-layout checkpoint (no model.safetensors)")
        sys.exit(1)
    print(f"Would push {files} from {ckpt_dir} to {repo_id}; the upload needs network access "
          "and is not ported")


if __name__ == "__main__":
    main()
