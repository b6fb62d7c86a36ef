"""Graph-building layer functions: every layer of the JAX package's
layers/nn.py, the control flow, the sequence and RNN layers, the tensor
creation and check layers, the in-program readers, the LR schedules,
accuracy and auc, the dense, beam-search and CRF/CTC layers of
layers/parity.py, and the collective and sharding layers of
layers/dist.py."""
from . import control_flow  # noqa: F401
from .control_flow import *  # noqa: F401,F403
from .dist import *  # noqa: F401,F403
from .io import (create_py_reader_by_data, data,  # noqa: F401
                 double_buffer, load, py_reader, read_file)
from .learning_rate_scheduler import (  # noqa: F401
    autoincreased_step_counter, cosine_decay, every_n_steps,
    exponential_decay, inverse_time_decay, linear_lr_warmup,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay)
from .math_ops import (elementwise_add, elementwise_div,  # noqa: F401
                       elementwise_floordiv, elementwise_max,
                       elementwise_min, elementwise_mod, elementwise_mul,
                       elementwise_pow, elementwise_sub)
from .metric_op import accuracy, auc  # noqa: F401
from .nn import *  # noqa: F401,F403
from .nn import argsort, pixel_shuffle_raw  # noqa: F401
from .parity import *  # noqa: F401,F403
from . import rnn  # noqa: F401
from .rnn import (RNNCell, GRUCell, LSTMCell, birnn,  # noqa: F401
                  BeamSearchDecoder, Decoder, dynamic_decode,
                  dynamic_gru, dynamic_lstm, dynamic_lstmp, gru_unit,
                  lstm_unit, lstm)
from .rnn import rnn as rnn_fn  # noqa: F401  (module name shadows the fn)
from . import sequence  # noqa: F401
from .sequence import *  # noqa: F401,F403
from .tensor import (argmax, argmin, assign, cast,  # noqa: F401
                     concat, create_global_var, create_parameter,
                     create_tensor, diag, eye, fill_constant,
                     fill_constant_batch_size_like, has_inf, has_nan,
                     isfinite, linspace, ones, ones_like, range, reverse,
                     zeros, zeros_like)
