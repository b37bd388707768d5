"""The port's stand-in for the reference's ``paddle`` package: during
``compat.config_parser.parse_config`` (and a provider's import) this
package is ``sys.modules["paddle"]``, and its submodules stand for
``paddle.trainer_config_helpers`` (with its eight submodules),
``paddle.trainer``, ``paddle.trainer.PyDataProvider2`` and
``paddle.trainer.config_parser`` (``config_parser.PADDLE_NAMES``).
Every implementation lives in ``paddle_tpu_torch``; nothing here imports
the repository's root ``paddle/`` package or the JAX package."""
