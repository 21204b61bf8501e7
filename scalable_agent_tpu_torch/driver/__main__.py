"""``python -m scalable_agent_tpu_torch.driver``: the CLI of ``driver``.

The entry lives in a module named ``__main__`` so that the env worker
processes, started with ``spawn``, do not re-run it: ``multiprocessing``
re-imports the parent's ``-m`` module in every child unless its name ends
in ``.__main__``, and the driver imports torch, which a worker must not.
"""

from scalable_agent_tpu_torch.driver import main

if __name__ == "__main__":
    main()
