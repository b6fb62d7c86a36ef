"""The MNIST models of the Fluid book (recognize_digits):
softmax_regression, multilayer_perceptron and
convolutional_neural_network (LeNet), which examples/train_mnist.py
trains with Adam."""
from __future__ import annotations

from .. import layers, nets


def softmax_regression(img, label):
    predict = layers.fc(img, size=10, act="softmax")
    cost = layers.cross_entropy(predict, label)
    return layers.mean(cost), predict


def multilayer_perceptron(img, label):
    h1 = layers.fc(img, size=200, act="tanh")
    h2 = layers.fc(h1, size=200, act="tanh")
    predict = layers.fc(h2, size=10, act="softmax")
    cost = layers.cross_entropy(predict, label)
    return layers.mean(cost), predict


def convolutional_neural_network(img, label):
    conv1 = nets.simple_img_conv_pool(img, num_filters=20, filter_size=5,
                                      pool_size=2, pool_stride=2, act="relu")
    conv2 = nets.simple_img_conv_pool(conv1, num_filters=50, filter_size=5,
                                      pool_size=2, pool_stride=2, act="relu")
    predict = layers.fc(conv2, size=10, act="softmax")
    cost = layers.cross_entropy(predict, label)
    return layers.mean(cost), predict
